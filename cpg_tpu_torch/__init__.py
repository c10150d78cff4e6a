"""cpg_tpu_torch: the PyTorch/CUDA port of cpg-tpu for one NVIDIA H100.

The package mirrors `cpg_tpu`'s module paths and state layout (the same
parameter keys, HWIO kernels, int8 ownership, NHWC activations at every public
function), so a state moves between the two packages by copying arrays. It
imports `torch` only. The hot kernels are hand-written CUDA C++ for sm_90a
under `csrc/`, built with nvcc at first use (`ops/_build.py`).

Entry points (`serve.TaskServer`, `inference.predict`,
`train.step.make_train_step`, `train.step.make_eval_step`,
`train.manager.Manager`, `train.sequence.run_sequence` and its
`init_state`/`grow_state`, `train.pretrained.convert_torch_cpg_checkpoint`,
`python -m cpg_tpu_torch sequence|baseline|packnet|pae|check|stats|
inference|export|export-torch|import-torch|serve`) run on the card by
default and raise when CUDA is missing; pass `device="cpu"` to run on the
CPU, where every kernel wrapper uses its plain PyTorch version.
"""

from .core.state import CPGState, TaskEntry
from .ops.binarize import DEFAULT_THRESHOLD, binarize, ternarize

__version__ = "0.1.0"
