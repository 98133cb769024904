"""Int8 KV cache for the decode engine, updated in place.

Per-(token, head) absmax quantization of K and V in the JAX package's
head-major layout: codes ``[L, B, H_kv, S, D]`` int8, scales
``[L, B, H_kv, S]`` f32 holding the absmax itself (a code times
``absmax / 127`` is the value). Unlike the JAX package's immutable pytree,
every write here mutates the cache's tensors in place and returns the cache
itself, so ``cache = cache.write_decode(...)`` reads the same in both.

Within a decode chunk, new tokens go to a per-chunk stage at one uniform
index per step (:meth:`KVCache.begin_stage`), and attention reads the stage
as a second key block; :meth:`KVCache.flush_stage` moves the chunk's valid
tokens into the main cache at the end of the chunk. The stage is allocated
once per chunk length and reset in place, and the flush runs on the
device without reading anything back, so a whole chunk can be captured in
a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class KVStage:
    """Per-chunk staging buffers: entry j of slot b holds the token that
    slot wrote at chunk step j (absolute position ``len0[b] + j``). Entries
    past ``step`` hold an earlier chunk's tokens: attention masks them and
    the flush never writes them."""

    k: torch.Tensor          # int8 [L, B, H, C, D]
    v: torch.Tensor
    k_scale: torch.Tensor    # f32 [L, B, H, C]
    v_scale: torch.Tensor
    step: int                # next write index in [0, C)
    len0: torch.Tensor       # int32 [B], slot lengths at chunk start


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # int8 [L, B, H, S, D]
    v: torch.Tensor
    k_scale: torch.Tensor    # f32 [L, B, H, S]
    v_scale: torch.Tensor
    lengths: torch.Tensor    # int32 [B]
    stage: Optional[KVStage] = None
    # chunk length -> its stage, allocated at the first begin_stage
    stages: Dict[int, KVStage] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    @classmethod
    def create(cls, num_layers: int, batch: int, max_seq: int,
               num_kv_heads: int, head_dim: int, *, device) -> "KVCache":
        shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[2]

    # -- chunk staging --------------------------------------------------
    def begin_stage(self, n_steps: int) -> "KVCache":
        """Open an ``n_steps``-entry stage (the JAX package's
        ``begin_stage(window=False)``); a no-op when ``n_steps`` exceeds
        the cache length. The stage of each ``n_steps`` is allocated once
        and reused: beginning resets its step index to 0 and copies the
        lengths into ``len0`` in place, so every chunk works on the same
        buffers (what a captured chunk needs)."""
        l, b, h, s, d = self.k.shape
        if n_steps > s:
            return self
        st = self.stages.get(n_steps)
        if st is None:
            dev = self.k.device
            st = self.stages[n_steps] = KVStage(
                k=torch.zeros((l, b, h, n_steps, d), dtype=torch.int8,
                              device=dev),
                v=torch.zeros((l, b, h, n_steps, d), dtype=torch.int8,
                              device=dev),
                k_scale=torch.ones((l, b, h, n_steps), dtype=torch.float32,
                                   device=dev),
                v_scale=torch.ones((l, b, h, n_steps), dtype=torch.float32,
                                   device=dev),
                step=0, len0=torch.empty_like(self.lengths))
        st.step = 0
        st.len0.copy_(self.lengths)
        self.stage = st
        return self

    def advance_stage(self) -> "KVCache":
        """Bump the stage's write index (once per decode step)."""
        if self.stage is not None:
            self.stage.step += 1
        return self

    def read_stage(self, layer: int):
        """(k [B,H,C,D], k_scale [B,H,C], v, v_scale, step) of a layer's
        stage: the second key block of staged attention."""
        st = self.stage
        return (st.k[layer], st.k_scale[layer], st.v[layer],
                st.v_scale[layer], st.step)

    def flush_stage(self) -> "KVCache":
        """Write each slot's valid staged tokens (the ``lengths - len0``
        emitted this chunk) to positions ``len0 + j`` of the main cache and
        close the stage.

        The JAX package's branch-free read-modify-write overlay, on the
        device with no host read: for slot b and staged entry j, position
        ``min(len0 + j, max_seq - 1)`` gets the staged value where
        ``j < lengths - len0`` and keeps what the cache holds elsewhere. A
        slot that went inactive mid-chunk thus writes only its valid
        entries, and a slot within C of ``max_seq`` moves none of its
        history. Valid entries never reach ``max_seq - 1`` (a slot stops at
        ``lengths == max_seq - 1``), so the clamped duplicates there only
        write back the value they read.
        """
        st = self.stage
        if st is None:
            return self
        s, c = self.max_seq, st.k.shape[3]
        dev = self.k.device
        j = torch.arange(c, device=dev)
        pos = torch.clamp(st.len0[:, None] + j, max=s - 1).long()   # [B, C]
        keep = j < (self.lengths - st.len0)[:, None]                  # [B, C]
        rows = torch.arange(pos.shape[0], device=dev)[:, None]
        for buf, staged in ((self.k, st.k), (self.v, st.v),
                            (self.k_scale, st.k_scale),
                            (self.v_scale, st.v_scale)):
            # [L, B, H, C(, D)] -> [B, C, L, H(, D)], the layout of the
            # gather below (its two index axes first)
            new = staged.permute(1, 3, 0, 2, *range(4, staged.dim()))
            cur = buf[:, rows, :, pos]
            mask = keep.reshape(keep.shape + (1,) * (cur.dim() - 2))
            buf[:, rows, :, pos] = torch.where(mask, new, cur)
        self.stage = None
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def _quant(x: torch.Tensor):
        """x [..., D] -> (int8 codes, f32 absmax [...])."""
        x32 = x.to(torch.float32)
        absmax = x32.abs().amax(dim=-1).clamp(min=1e-8)
        # one f32 division, as in the JAX package (127.0 / t would multiply
        # by the reciprocal)
        inv = torch.full_like(absmax, 127.0) / absmax
        q = torch.clamp(torch.round(x32 * inv[..., None]),
                        -127, 127).to(torch.int8)
        return q, absmax

    def write_prefill(self, layer: int, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> "KVCache":
        """Write [S_p, H, D] k/v of one slot at positions [0, S_p) (in
        place)."""
        kq, ks = self._quant(k_new.transpose(0, 1))       # [H, S_p, D]
        vq, vs = self._quant(v_new.transpose(0, 1))
        sl = slice(0, k_new.shape[0])
        self.k[layer, slot, :, sl] = kq
        self.v[layer, slot, :, sl] = vq
        self.k_scale[layer, slot, :, sl] = ks
        self.v_scale[layer, slot, :, sl] = vs
        return self

    def write_decode(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, positions: torch.Tensor,
                     slots: Optional[torch.Tensor] = None) -> "KVCache":
        """Write k_new/v_new [B, S, H, D] at ``positions`` ([B] with S == 1,
        or [B, S]) in place. Inside a decode chunk (``slots`` None, S == 1)
        the tokens go to the stage at its uniform step index. ``slots`` [R]
        sends row r to cache slot ``slots[r]`` (batched prefill); duplicate
        slots must carry identical rows."""
        kq, ks = self._quant(k_new.transpose(1, 2))        # [B, H, S, D]
        vq, vs = self._quant(v_new.transpose(1, 2))
        st = self.stage
        if st is not None and slots is None and k_new.shape[1] == 1:
            st.k[layer, :, :, st.step] = kq[:, :, 0]
            st.v[layer, :, :, st.step] = vq[:, :, 0]
            st.k_scale[layer, :, :, st.step] = ks[:, :, 0]
            st.v_scale[layer, :, :, st.step] = vs[:, :, 0]
            return self
        if positions.dim() == 1:
            positions = positions[:, None]
        b = k_new.shape[0]
        dev = self.k.device
        b_idx = (torch.arange(b, device=dev) if slots is None
                 else slots.long())[:, None, None]
        h_idx = torch.arange(self.num_kv_heads, device=dev)[None, :, None]
        pos = positions.long()[:, None, :]
        self.k[layer, b_idx, h_idx, pos] = kq
        self.v[layer, b_idx, h_idx, pos] = vq
        self.k_scale[layer, b_idx, h_idx, pos] = ks
        self.v_scale[layer, b_idx, h_idx, pos] = vs
        return self

    def read_raw(self, layer: int, span: Optional[int] = None):
        """Views (no copy) of a layer's first ``span`` positions: codes
        [B, H, span, D] and scales [B, H, span], as (k, k_scale, v,
        v_scale)."""
        sl = slice(0, span)
        return (self.k[layer, :, :, sl], self.k_scale[layer, :, :, sl],
                self.v[layer, :, :, sl], self.v_scale[layer, :, :, sl])

    def bytes_per_token(self) -> int:
        l, _, h, _, d = self.k.shape
        return l * (2 * h * d + 2 * h * 4)
