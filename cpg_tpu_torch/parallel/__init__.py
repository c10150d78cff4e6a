"""Data parallelism over torch.distributed ranks (`distributed.py`,
`mesh.py`, `collectives.py`): one process a device in training, one
process over several devices in serving. The model and pipeline axes of
`cpg_tpu.parallel` are not ported yet (ROADMAP Queue 1, item 12)."""
