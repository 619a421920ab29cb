from .monitor import (CSVMonitor, Monitor, MonitorMaster, TensorBoardMonitor,
                      WandbMonitor)

__all__ = ["Monitor", "MonitorMaster", "CSVMonitor", "TensorBoardMonitor",
           "WandbMonitor"]
