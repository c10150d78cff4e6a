"""State invariant checks, run eagerly at phase boundaries.

Same audit as `cpg_tpu.core.invariants.check_state`. The JAX package's
`checkified` (jax checkify float checks folded into a jitted step) has no
counterpart here: the port's step runs eagerly, and `check_state` reads
the finiteness of every weight and piggymask directly.
"""

from __future__ import annotations

from typing import List

import torch

from .state import CPGState


class InvariantViolation(AssertionError):
    pass


def check_state(state: CPGState, strict: bool = True,
                expect_zero_free: bool = None) -> List[str]:
    """Audit the CPG bookkeeping. Returns violation strings ([] if clean);
    raises InvariantViolation when strict.

    Invariants:
      I1 ownership values are in [0, num_tasks]
      I2 free (ownership==0) weights are exactly zero
      I3 shared weights and piggymasks are finite
      I4 every task's piggymask matches the shared tree's shapes
      I5 shared/ownership trees have identical keys and shapes

    I2 scope: a fresh init_state before the first start_task, and the window
    between grow_state and the next start_task, hold fresh init on FREE
    entries (invisible to every forward; the train step zeroes them).
    `expect_zero_free` defaults to auto: I2 is enforced once any task
    exists; pass False when auditing right after grow_state."""
    if expect_zero_free is None:
        expect_zero_free = state.num_tasks > 0
    v = []
    n = state.num_tasks
    for k, own in state.ownership.items():
        if k not in state.shared:
            v.append(f"I5: ownership key {k} missing from shared")
            continue
        w = state.shared[k]
        if tuple(own.shape) != tuple(w.shape):
            v.append(f"I5: {k} ownership{tuple(own.shape)} != "
                     f"weight{tuple(w.shape)}")
            continue
        mx, mn = int(own.max()), int(own.min())
        if mn < 0 or mx > n:
            v.append(f"I1: {k} ownership range [{mn},{mx}] outside [0,{n}]")
        if expect_zero_free:
            leak = float(torch.where(own == 0, w, 0).abs().max())
            if leak != 0.0:
                v.append(f"I2: {k} free weights nonzero (max |w|={leak:g})")
        if not bool(torch.isfinite(w).all()):
            v.append(f"I3: {k} non-finite shared weights")
    for tid, t in state.tasks.items():
        if t.piggymask is None:
            continue
        for k, pm in t.piggymask.items():
            if k not in state.shared:
                v.append(f"I4: task {tid} piggymask key {k} not in shared")
            elif tuple(pm.shape) != tuple(state.shared[k].shape):
                v.append(f"I4: task {tid} {k} piggymask{tuple(pm.shape)} != "
                         f"weight{tuple(state.shared[k].shape)}")
            elif not bool(torch.isfinite(pm).all()):
                v.append(f"I3: task {tid} {k} non-finite piggymask")
    if v and strict:
        raise InvariantViolation("; ".join(v))
    return v
