"""`DevicePrefetcher` (data/stream.py) on a CUDA card.

Marked `gpu`: each test skips (with its reason) when CUDA is not
available. It imports no JAX, so on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_stream.py -q

The prefetcher's side stream is held ~10 ms (`torch.cuda._sleep`) before
each copy, so a staging pair written again before its copy read it would
hand the consuming stream another batch's rows; the control skips the
waits and must see that happen.
"""

import numpy as np
import pytest
import torch

from cpg_tpu_torch.data import stream as t_stream

pytestmark = pytest.mark.gpu


def _prefetched_on_the_card(host, depth, skip_waits):
    """(batches received, indices differing from `host`, pairs written
    again) of a CUDA prefetcher over `host` whose side stream is held
    ~10 ms before each copy; `skip_waits` drops the pairs' events before
    each write."""
    pf = None

    def held_back():
        for xy in host:
            with torch.cuda.stream(pf._stream):
                torch.cuda._sleep(20_000_000)
            if skip_waits:
                for slot in pf._slots:
                    slot.done = None
            yield xy

    pf = t_stream.DevicePrefetcher(held_back(), "cuda", depth=depth)
    got = [(bx.clone(), by.clone()) for bx, by in pf]
    torch.cuda.synchronize()
    bad = [i for i, ((bx, by), (hx, hy)) in enumerate(zip(got, host))
           if not (np.array_equal(bx.cpu().numpy(), hx)
                   and np.array_equal(by.cpu().numpy(), hy))]
    return len(got), bad, pf.rewrites


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetcher_on_the_card_waits_before_rewriting(depth):
    """Twelve distinct batches through the prefetcher on CUDA with its
    copies held back: each arrives byte-equal to its host batch and
    12 - (depth + 1) staging pairs were written again, each after its
    copy's event. With the waits skipped some batch differs, so the check
    sees a pair written before its copy read it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    rng = np.random.RandomState(depth)
    host = [(rng.randint(0, 256, (32, 64, 64, 3)).astype(np.uint8),
             rng.randint(0, 100, 32).astype(np.int32)) for _ in range(12)]
    assert _prefetched_on_the_card(host, depth, False) == (
        12, [], 12 - (depth + 1))
    n, bad, _ = _prefetched_on_the_card(host, depth, True)
    assert n == 12 and bad
