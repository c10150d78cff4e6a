"""Losses and accuracy (same math as `cpg_tpu.train.losses`): cross-entropy
for the classification tasks and the annealed A-Softmax loss of the face
task (SphereFace's AngleLoss, m = 4)."""

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


def make_angle_loss(lambda_min=5.0, lambda_base=1500.0, gamma=0.12,
                    power=1.0):
    """SphereFace's annealed A-Softmax loss over the AngleLinear head's
    (cos_theta, phi_theta), both scaled by |x|, the labels and the global
    step `it`; the margin term anneals in as
        lambda(it) = max(lambda_min, lambda_base / (1 + gamma*it)^power)
        f_y = (lambda * cos_y + phi_y) / (1 + lambda)."""

    def loss(out, labels, it):
        cos_theta, phi_theta = out
        lamb = max(lambda_min, lambda_base / (1.0 + gamma * float(it)) ** power)
        onehot = torch.nn.functional.one_hot(
            labels.long(), cos_theta.shape[-1]).to(cos_theta.dtype)
        blended = (cos_theta - onehot * cos_theta / (1.0 + lamb)
                   + onehot * phi_theta / (1.0 + lamb))
        logp = torch.log_softmax(blended.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()

    loss.wants_step = True
    return loss
