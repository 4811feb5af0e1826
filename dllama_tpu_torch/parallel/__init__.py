"""Tensor parallelism of the port: the world of ranks (``group``), the
activation gathers (``collectives``) and the output-sharded quantized
weights (``quant_tp``)."""
