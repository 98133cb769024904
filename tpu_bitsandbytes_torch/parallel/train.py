"""The QLoRA training step, on one device or under a (dp, tp) mesh.

Frozen 4-bit base weights and trainable LoRA adapters: gradients reach
only the adapters' A and B, which an 8-bit transform updates
(``tpu_bitsandbytes/parallel/train.py``). The step runs eagerly; each
frozen linear's forward takes the kernel the JAX package's dispatch names
for its shape (K5 up to M = 256 rows), and its backward the JAX package's
rule against the dequantized weight.

Under a mesh (one process per rank, ``torch.distributed``) the step
computes what the JAX package's GSPMD step computes over a batch split
over dp and weights split over tp: the mean NLL of the global batch, its
gradients, and one update of the whole adapters. Each rank takes its dp
rows of the batch; the frozen base is the rank's tp shard
(:func:`~.sharding.shard_params`), run through the model code's
tensor-parallel hooks with Megatron's pair of autograd collectives (a sum
over tp after a row-parallel linear in the forward, and before a
column-parallel linear in the backward); the adapters stay whole and
replicated, each rank applying its slice (:class:`~.tp.ShardedLoRA`). The
gradients are summed over tp (which gathers the sliced factors and
completes the whole ones) and averaged over dp, so every rank applies the
same 8-bit update to the same adapters: the 8-bit state is blockwise over
each whole leaf, as in the JAX package, and the replicas stay bit
identical.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import llama
from ..models.layers import linear_apply
from ..models.lora import lora_trainable, merge_lora_trainable
from ..optim import transforms
from .tp import TPContext, _row_bias

__all__ = ["make_qlora_train_step", "qlora_loss_and_grads", "TrainTPContext"]


class _CopyToTP(torch.autograd.Function):
    """The input of a column-parallel linear: the identity in the forward,
    the gradient summed over tp in the backward (each rank's shard sees
    only its own output columns' share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The output of a row-parallel linear: the partials summed over tp in
    the forward, the identity in the backward (every rank holds the whole
    gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """Column shards [.., X/tp] gathered to [.., X] in tp rank order; the
    backward keeps this rank's columns of the gradient (the loss after
    the gather is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


class TrainTPContext(TPContext):
    """:class:`~.tp.TPContext` for training: the same shards and hooks,
    with collectives that carry gradients (Megatron's pair) in place of
    serving's in-place all-reduce, and the gradient and loss reductions of
    the step."""

    def __init__(self, mesh, config: llama.LlamaConfig):
        super().__init__(mesh, config)
        self._copied = (None, None)

    def _to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering column-parallel linears: one copy per input
        tensor (q, k and v share theirs, as gate and up do), so its
        gradient is summed over tp once, after autograd has accumulated
        every consumer's share in the order one device accumulates them."""
        last, out = self._copied
        if last is not x:
            out = _CopyToTP.apply(x, self.tp_group)
            self._copied = (x, out)
        return out

    def wrap(self, w, row: bool = False):
        local = super().wrap(w, row)
        if row:
            return local
        return lambda x: linear_apply(local, self._to_tp(x))

    def reduce_fn(self, partial: torch.Tensor, w) -> torch.Tensor:
        out = _ReduceFromTP.apply(partial, self.tp_group)
        bias = _row_bias(w)
        return out if bias is None else out + bias.to(out.dtype)

    def head_logits(self, params, x: torch.Tensor,
                    config: llama.LlamaConfig) -> torch.Tensor:
        head = params.get("lm_head")
        if head is None:
            logits = x @ params["embed"].t().to(x.dtype)
        else:
            logits = _GatherFromTP.apply(linear_apply(self.wrap(head), x),
                                         self.tp_group, self.tp_rank,
                                         self.tp)
        return llama.finish_logits(logits, config)

    def local_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's dp rows of the global batch."""
        b = tokens.shape[0]
        if b % self.dp:
            raise ValueError(f"a batch of {b} rows does not divide by "
                             f"dp={self.dp}")
        per = b // self.dp
        return tokens[self.dp_rank * per:(self.dp_rank + 1) * per]

    def reduce_grads(self, grads):
        """Each gradient summed over tp, then averaged over dp (one
        all-reduce per group and dtype over the flattened gradients)."""
        grads = list(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.tp_group)
            dist.all_reduce(flat, group=self.dp_group)
            flat = flat / self.dp
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                grads[i] = part.view_as(grads[i])
        return grads

    def mean_dp(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over dp of a per-rank value."""
        t = t.clone()
        dist.all_reduce(t, group=self.dp_group)
        return t / self.dp


def _loss_and_grads(config, trainable, frozen_params, tokens, remat,
                    ctx=None):
    if ctx is not None:
        tokens = ctx.local_rows(tokens)
    params = merge_lora_trainable(frozen_params, trainable)
    leaves = lora_trainable(params)
    with torch.enable_grad():
        logits = llama.forward(params, tokens[:, :-1], config, remat=remat,
                               tp=ctx)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tgt = tokens[:, 1:].long()
        loss = -torch.gather(logp, -1, tgt[..., None]).mean()
        grads = torch.autograd.grad(loss, transforms.tree_leaves(leaves))
    loss = loss.detach()
    if ctx is not None:
        ctx._copied = (None, None)
        grads = ctx.reduce_grads(grads)
        loss = ctx.mean_dp(loss)
    return loss, transforms.tree_unflatten(leaves, grads)


def qlora_loss_and_grads(config: llama.LlamaConfig, trainable,
                         frozen_params, tokens, remat: bool = False,
                         mesh=None):
    """The QLoRA loss and its gradients in the adapters: ``trainable``
    merged into ``frozen_params`` (the LoRA-attached tree), the mean
    next-token NLL of ``tokens[:, 1:]`` (tokens [B, S + 1]) under a
    log-softmax in f32. Returns ``(loss, grads)``, the grads a tree shaped
    like ``trainable`` in its dtypes. Under ``mesh``: ``frozen_params`` is
    this rank's shards (:func:`~.sharding.shard_params` of the
    LoRA-attached tree), ``tokens`` the global batch (B divisible by dp),
    and the loss and gradients are the global batch's, equal on every
    rank."""
    ctx = None if mesh is None else TrainTPContext(mesh, config)
    return _loss_and_grads(config, trainable, frozen_params, tokens, remat,
                           ctx)


def make_qlora_train_step(config: llama.LlamaConfig, tx=None,
                          remat: bool = False, mesh=None):
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

    ``mesh``: a ("dp", "tp") mesh (:func:`~.mesh.make_mesh`); every rank
    calls the step with the same ``trainable`` and ``opt_state`` (whole,
    replicated), its own shards as ``frozen_params`` and the global batch
    as ``tokens``, and gets the same new adapters, state and loss (the
    module docstring).
    """
    tx = tx or transforms.adam8bit(1e-4)
    ctx = None if mesh is None else TrainTPContext(mesh, config)

    def train_step(trainable, opt_state, frozen_params, tokens):
        loss, grads = _loss_and_grads(config, trainable, frozen_params,
                                      tokens, remat, ctx)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, trainable)
            trainable = transforms.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    return tx.init, train_step
