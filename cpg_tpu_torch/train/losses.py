"""Classification losses and accuracy (same math as `cpg_tpu.train.losses`)."""

from __future__ import annotations

import torch


def class_logits(out):
    """Model outputs may be plain logits or a (cos_theta, phi_theta) tuple
    from an angular head; classification uses the first part."""
    return out[0] if isinstance(out, tuple) else out


def call_loss(loss_fn, logits, labels, it):
    """Dispatch to loss_fn, passing the global step to losses that anneal
    (`wants_step`); plain losses take (logits, labels)."""
    if getattr(loss_fn, "wants_step", False):
        return loss_fn(logits, labels, it)
    return loss_fn(class_logits(logits), labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def make_cross_entropy(label_smoothing: float = 0.0):
    """CE with uniform label smoothing: target = (1-eps)*onehot + eps/C.
    label_smoothing=0 returns the plain `cross_entropy`."""
    if not label_smoothing:
        return cross_entropy

    def loss(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.long()[:, None]).mean()
        uniform = -logp.mean()
        return (1.0 - label_smoothing) * nll + label_smoothing * uniform

    return loss


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
