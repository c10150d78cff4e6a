"""Parallelism over torch.distributed ranks (`distributed.py`, `mesh.py`,
`collectives.py`): one process a device in training, along the data axes
and the model axis (kernels split over the ranks of a model group), one
process over several devices in serving. `cpg_tpu.parallel`'s activation
sharding (`act_sharder`) and pipeline (`pipeline.py`) are not ported yet
(ROADMAP Queue 1, item 12)."""
