"""Parallelism of the port on one device: mixture-of-experts layers
(``moe``, counterpart of ``deepspeed_tpu/parallel/moe.py``)."""
