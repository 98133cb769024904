"""The QLoRA training step on one device.

Frozen 4-bit base weights and trainable LoRA adapters: gradients reach
only the adapters' A and B, which an 8-bit transform updates
(``tpu_bitsandbytes/parallel/train.py``, its single-device part). The step
runs eagerly; each frozen linear's forward takes the kernel the JAX
package's dispatch names for its shape (K5 up to M = 256 rows), and its
backward the JAX package's rule against the dequantized weight.
"""

from __future__ import annotations

import torch

from ..models import llama
from ..models.lora import lora_trainable, merge_lora_trainable
from ..optim import transforms

__all__ = ["make_qlora_train_step", "qlora_loss_and_grads"]


def qlora_loss_and_grads(config: llama.LlamaConfig, trainable,
                         frozen_params, tokens, remat: bool = False):
    """The QLoRA loss and its gradients in the adapters: ``trainable``
    merged into ``frozen_params`` (the LoRA-attached tree), the mean
    next-token NLL of ``tokens[:, 1:]`` (tokens [B, S + 1]) under a
    log-softmax in f32. Returns ``(loss, grads)``, the grads a tree shaped
    like ``trainable`` in its dtypes."""
    params = merge_lora_trainable(frozen_params, trainable)
    leaves = lora_trainable(params)
    with torch.enable_grad():
        logits = llama.forward(params, tokens[:, :-1], config, remat=remat)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tgt = tokens[:, 1:].long()
        loss = -torch.gather(logp, -1, tgt[..., None]).mean()
        grads = torch.autograd.grad(loss, transforms.tree_leaves(leaves))
    return loss.detach(), transforms.tree_unflatten(leaves, grads)


def make_qlora_train_step(config: llama.LlamaConfig, tx=None,
                          remat: bool = False):
    """Returns ``(init_opt_state, train_step)``.

    ``train_step(trainable, opt_state, frozen_params, tokens)`` ->
    ``(trainable, opt_state, loss)``: ``frozen_params`` is the
    LoRA-attached (quantized) tree, ``trainable`` its
    :func:`~tpu_bitsandbytes_torch.models.lora.lora_trainable` leaves and
    ``tokens`` [B, S + 1] (:func:`qlora_loss_and_grads`). The new
    ``trainable`` holds new tensors, each ``A + update`` in A's dtype, as
    ``optax.apply_updates`` adds them. ``tx`` defaults to
    ``adam8bit(1e-4)``; ``remat`` recomputes each layer in the backward
    pass (``llama.forward(remat=True)``).
    """
    tx = tx or transforms.adam8bit(1e-4)

    def train_step(trainable, opt_state, frozen_params, tokens):
        loss, grads = qlora_loss_and_grads(config, trainable, frozen_params,
                                           tokens, remat)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, trainable)
            trainable = transforms.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    return tx.init, train_step
