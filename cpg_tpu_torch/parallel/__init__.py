"""Parallelism over torch.distributed ranks (`distributed.py`, `mesh.py`,
`collectives.py`, `pipeline.py`): one process a device in training, along
the data axes, the model axis (kernels split over the ranks of a model
group; with `act_sharder`, a transformer's tokens and an MoE layer's
experts too) and the pipe axis (GPipe over stage ranks), one process over
several devices in serving."""
