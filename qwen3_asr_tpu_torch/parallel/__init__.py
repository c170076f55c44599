"""Parallelism on torch.distributed: the dp x tp mesh, the GPipe pipeline
and the collectives the sharded layers call (counterpart of
``qwen3_asr_tpu/parallel/``)."""
