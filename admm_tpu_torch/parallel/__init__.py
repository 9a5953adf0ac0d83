"""Consensus (parallel) ADMM on one device (counterpart of ``admm_tpu/parallel``)."""
