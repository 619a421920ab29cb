from .elasticity import (ElasticityError, compute_elastic_config,
                         elasticity_fingerprint, ensure_immutable,
                         get_candidate_batch_sizes, get_valid_devices)

__all__ = ["compute_elastic_config", "get_candidate_batch_sizes",
           "get_valid_devices", "elasticity_fingerprint",
           "ensure_immutable", "ElasticityError"]
