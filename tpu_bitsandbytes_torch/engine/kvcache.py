"""KV cache for the decode engine, updated in place: int8, or unquantized.

Per-(token, head) absmax quantization of K and V in the JAX package's
head-major layout: codes ``[L, B, H_kv, S, D]`` int8, scales
``[L, B, H_kv, S]`` f32 holding the absmax itself (a code times
``absmax / 127`` is the value). ``create(quantized=False)`` keeps K and V in
the model's dtype with no scales (the JAX package's exact-attention mode).
Unlike the JAX package's immutable pytree, every write here mutates the
cache's tensors in place and returns the cache itself, so
``cache = cache.write_decode(...)`` reads the same in both.

Within a decode chunk, new tokens go to a per-chunk stage at one uniform
index per step (:meth:`KVCache.begin_stage`); :meth:`KVCache.flush_stage`
moves the chunk's valid tokens into the main cache at the end of the chunk.
The two-block stage (``window=False``) holds the staged tokens alone, and
attention reads it as a second key block beside the cache's span. The
compact-window stage (``window=True``, the JAX package's default) holds a
copy of the span ``[start, span)`` followed by the staged tokens, and
attention reads that window as one block (:meth:`KVCache.read_window`).
The stage buffers are allocated once per chunk length (a window's at the
widest window, ``max_seq + C`` entries, viewed per span) and reset in place,
and the span copy and the flush run on the device without reading anything
back, so a whole chunk can be captured in a CUDA graph. An unquantized
cache has no stage (as in the JAX package): decode writes scatter into it.

A ring cache (``create(ring_size=)``, for models whose every layer has a
sliding window) keeps only the last ``ring`` positions: absolute position
p lives at index ``p % ring``, ``lengths`` stay absolute, and attention
reads the whole ring under the ring mask (``models.layers._causal_mask``).
It has no stage either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class KVStage:
    """Per-chunk staging buffers: tail entry j of slot b (index ``cut + j``)
    holds the token that slot wrote at chunk step j (absolute position
    ``len0[b] + j``). Tail entries past ``step`` hold an earlier chunk's
    tokens: attention masks them and the flush never writes them. In the
    compact-window mode (``cut > 0``) entries ``[0, cut)`` hold a copy of
    the main cache's span ``[start, span)``, taken at the chunk's start."""

    k: torch.Tensor          # int8 [L, B, H, cut + C, D]
    v: torch.Tensor
    k_scale: torch.Tensor    # f32 [L, B, H, cut + C]
    v_scale: torch.Tensor
    step: int                # next write index in [0, C)
    len0: torch.Tensor       # int32 [B], slot lengths at chunk start
    cut: int = 0             # the window's span copy (0: two-block stage)

    @property
    def size(self) -> int:
        """Staged capacity C (chunk steps), the window's copy excluded."""
        return self.k.shape[3] - self.cut


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # int8 [L, B, H, S, D] (the model dtype unquantized)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]    # f32 [L, B, H, S]; None unquantized
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor    # int32 [B]
    # ring mode: the S axis rolls over the last S positions, and
    # max_positions is the absolute bound (None in plain mode)
    ring: bool = False
    max_positions: Optional[int] = None
    # the dtype :meth:`read` dequantizes to (the model's)
    dtype: torch.dtype = torch.bfloat16
    stage: Optional[KVStage] = None
    # chunk length -> its two-block stage, allocated at the first
    # begin_stage(window=False)
    stages: Dict[int, KVStage] = dataclasses.field(default_factory=dict,
                                                   repr=False)
    # chunk length -> its window stage's buffers (k, v, k_scale, v_scale)
    # at the widest window, max_seq + C entries, and its len0
    windows: Dict[int, tuple] = dataclasses.field(default_factory=dict,
                                                  repr=False)

    @classmethod
    def create(cls, num_layers: int, batch: int, max_seq: int,
               num_kv_heads: int, head_dim: int, *, quantized: bool = True,
               dtype=torch.bfloat16, device,
               ring_size: Optional[int] = None) -> "KVCache":
        """``quantized=False``: K and V in ``dtype``, no scales.
        ``ring_size``: a rolling S axis of that many entries (it must
        exceed the model's window plus the positions in flight) while
        ``max_seq`` stays the absolute bound; a ring at least ``max_seq``
        long is a plain cache."""
        s_axis = max_seq if ring_size is None else min(ring_size, max_seq)
        ring = s_axis < max_seq
        shape = (num_layers, batch, num_kv_heads, s_axis, head_dim)
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
        mode = dict(lengths=lengths, ring=ring,
                    max_positions=max_seq if ring else None, dtype=dtype)
        if not quantized:
            return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       k_scale=None, v_scale=None, **mode)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            **mode)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_seq(self) -> int:
        """The S axis: the ring's size in ring mode."""
        return self.k.shape[3]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[2]

    # -- chunk staging --------------------------------------------------
    def begin_stage(self, n_steps: int, span: Optional[int] = None,
                    start: int = 0, window: bool = True) -> "KVCache":
        """Open an ``n_steps``-entry stage, as the JAX package's
        ``begin_stage``: a no-op when ``n_steps`` exceeds the cache length,
        and for an unquantized or a ring cache.

        ``window=True``: the compact-window stage. Its entries ``[0,
        cut)``, ``cut = span - start`` (``span`` None: the whole cache),
        are a copy of the main cache's positions ``[start, span)``, made on
        the device here, and the ``n_steps`` staged entries follow; decode
        attention reads the window as one block (:meth:`read_window`).
        ``window=False``: the two-block stage of the staged entries alone,
        read beside the cache's span (:meth:`read_stage`).

        Each chunk length's buffers are allocated once and reused (a
        window's at ``max_seq + n_steps`` entries, viewed at ``cut +
        n_steps``): beginning resets the step index to 0 and copies the
        lengths into ``len0`` in place, so every chunk works on the same
        addresses (what a captured chunk needs)."""
        s = self.max_seq
        if n_steps > s or not self.quantized or self.ring:
            return self
        if window:
            hi = s if span is None else span
            cut = hi - start
            bufs = self.windows.get(n_steps)
            if bufs is None:
                bufs = self.windows[n_steps] = (
                    *self._stage_buffers(s + n_steps),
                    torch.empty_like(self.lengths))
            *full, len0 = bufs
            w = cut + n_steps
            views = [x[:, :, :, :w] for x in full]
            for view, main in zip(views, (self.k, self.v, self.k_scale,
                                          self.v_scale)):
                view[:, :, :, :cut].copy_(main[:, :, :, start:hi])
            len0.copy_(self.lengths)
            self.stage = KVStage(*views, step=0, len0=len0, cut=cut)
            return self
        st = self.stages.get(n_steps)
        if st is None:
            st = self.stages[n_steps] = KVStage(
                *self._stage_buffers(n_steps), step=0,
                len0=torch.empty_like(self.lengths))
        st.step = 0
        st.len0.copy_(self.lengths)
        self.stage = st
        return self

    def _stage_buffers(self, n: int):
        """(k, v, k_scale, v_scale) stage buffers of ``n`` entries per slot
        and head: zero codes, unit scales."""
        l, b, h, _, d = self.k.shape
        dev = self.k.device
        codes = lambda: torch.zeros((l, b, h, n, d), dtype=torch.int8,
                                    device=dev)
        scales = lambda: torch.ones((l, b, h, n), dtype=torch.float32,
                                    device=dev)
        return codes(), codes(), scales(), scales()

    def window_bytes(self) -> int:
        """Device bytes of the window stages' buffers allocated so far."""
        return sum(x.numel() * x.element_size()
                   for bufs in self.windows.values() for x in bufs[:4])

    def advance_stage(self) -> "KVCache":
        """Bump the stage's write index (once per decode step)."""
        if self.stage is not None:
            self.stage.step += 1
        return self

    def read_stage(self, layer: int):
        """(k [B,H,C,D], k_scale [B,H,C], v, v_scale, step) of a layer's
        staged entries (a window stage's tail, from ``cut`` on): the second
        key block of two-block staged attention."""
        st = self.stage
        c = st.cut
        return (st.k[layer][:, :, c:], st.k_scale[layer][:, :, c:],
                st.v[layer][:, :, c:], st.v_scale[layer][:, :, c:], st.step)

    def read_window(self, layer: int):
        """A window stage's whole window for a layer: (k [B,H,cut+C,D],
        k_scale [B,H,cut+C], v, v_scale), views
        (:func:`~..models.layers.gqa_attention_kv_window`)."""
        st = self.stage
        return st.k[layer], st.k_scale[layer], st.v[layer], st.v_scale[layer]

    def flush_stage(self) -> "KVCache":
        """Write each slot's valid staged tokens (the ``lengths - len0``
        emitted this chunk, from the stage's tail) to positions ``len0 +
        j`` of the main cache and close the stage.

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
        s, c = self.max_seq, st.size
        dev = self.k.device
        j = torch.arange(c, device=dev)
        pos = torch.clamp(st.len0[:, None] + j, max=s - 1).long()   # [B, C]
        keep = j < (self.lengths - st.len0)[:, None]                  # [B, C]
        rows = torch.arange(pos.shape[0], device=dev)[:, None]
        for buf, staged in ((self.k, st.k), (self.v, st.v),
                            (self.k_scale, st.k_scale),
                            (self.v_scale, st.v_scale)):
            # the tail, [L, B, H, C(, D)] -> [B, C, L, H(, D)], the layout
            # of the gather below (its two index axes first)
            new = staged[:, :, :, st.cut:].permute(
                1, 3, 0, 2, *range(4, staged.dim()))
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
                      v_new: torch.Tensor,
                      valid_len: Optional[int] = None) -> "KVCache":
        """Write [S_p, H, D] k/v of one slot at positions [0, S_p) (in
        place). A ring cache writes position p at ``p % ring`` and drops
        the padding at or past ``valid_len`` (it would wrap onto real
        entries) and the positions a ring's length behind the last kept
        one, as the JAX package's ring write does."""
        # [H, S_p, D]
        k_hm, v_hm = k_new.transpose(0, 1), v_new.transpose(0, 1)
        if self.quantized:
            (kq, ks), (vq, vs) = self._quant(k_hm), self._quant(v_hm)
            writes = ((self.k, kq), (self.v, vq), (self.k_scale, ks),
                      (self.v_scale, vs))
        else:
            writes = ((self.k, k_hm.to(self.k.dtype)),
                      (self.v, v_hm.to(self.v.dtype)))
        s_p = k_new.shape[0]
        if not self.ring:
            for buf, new in writes:
                buf[layer, slot, :, :s_p] = new
            return self
        ring = self.max_seq
        last = s_p - 1 if valid_len is None else min(s_p, valid_len) - 1
        lo = max(0, last - ring + 1)
        idx = torch.arange(lo, last + 1, device=self.k.device)
        for buf, new in writes:
            buf[layer, slot][:, idx % ring] = new[:, lo:last + 1]
        return self

    def _inside(self, pos: torch.Tensor):
        """Write positions [R, S] past the cache, dropped as the JAX
        package's scatter drops them, with no read back to the host: each
        such entry is sent to its row's last position inside the cache and
        writes that entry's values, so the colliding writes are equal.
        Every row has a position inside (a prefill chunk starts inside its
        prompt, a verify step at a slot's length). Returns (positions, take [R, S]: the entry whose values
        each writes)."""
        inside = pos < self.max_seq
        j = torch.arange(pos.shape[1], device=pos.device)
        last = torch.where(inside, pos, -1).argmax(dim=-1, keepdim=True)
        take = torch.where(inside, j, last)
        return pos.gather(1, take), take

    def write_decode(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, positions: torch.Tensor,
                     slots=None) -> "KVCache":
        """Write k_new/v_new [B, S, H, D] at ``positions`` ([B] with S == 1,
        or [B, S]) in place. Inside a decode chunk (``slots`` None, S == 1)
        an int8 cache takes the tokens into the stage at its uniform step
        index (after a window's span copy). ``slots`` (int32 [R], or one
        slot as an int) sends row r to cache slot ``slots[r]`` (batched and
        chunked prefill); duplicate slots must carry identical rows. Positions at or past ``max_seq``
        are dropped (a final prefill chunk's padding, a verify step's
        drafts past the end)."""
        k_hm, v_hm = k_new.transpose(1, 2), v_new.transpose(1, 2)  # [B,H,S,D]
        st = self.stage
        if st is not None and slots is None and k_new.shape[1] == 1:
            kq, ks = self._quant(k_hm)
            vq, vs = self._quant(v_hm)
            at = st.cut + st.step
            st.k[layer, :, :, at] = kq[:, :, 0]
            st.v[layer, :, :, at] = vq[:, :, 0]
            st.k_scale[layer, :, :, at] = ks[:, :, 0]
            st.v_scale[layer, :, :, at] = vs[:, :, 0]
            return self
        if positions.dim() == 1:
            positions = positions[:, None]
        b = k_new.shape[0]
        dev = self.k.device
        if slots is None:
            rows = torch.arange(b, device=dev)
        elif isinstance(slots, int):
            rows = torch.full((b,), slots, device=dev)
        else:
            rows = slots.long()
        b_idx = rows[:, None, None]
        h_idx = torch.arange(self.num_kv_heads, device=dev)[None, :, None]
        pos = positions.long()
        if self.ring:
            # a chunk's positions are fewer than the ring: distinct indices
            pos = torch.remainder(pos, self.max_seq)
        if self.quantized:
            (kq, ks), (vq, vs) = self._quant(k_hm), self._quant(v_hm)
            writes = ((self.k, kq), (self.v, vq), (self.k_scale, ks),
                      (self.v_scale, vs))
        else:
            writes = ((self.k, k_hm.to(self.k.dtype)),
                      (self.v, v_hm.to(self.v.dtype)))
        take = None
        if pos.shape[1] > 1 and not self.ring:
            # one decode token per slot stays below max_seq: only a
            # prefill's padding can reach past it
            pos, take = self._inside(pos)
        pos = pos[:, None, :]
        for buf, new in writes:
            if take is not None:
                tail = (1,) * (new.dim() - 3)
                new = new.gather(2, take.reshape(take.shape[0], 1, -1, *tail)
                                 .expand_as(new))
            buf[layer, b_idx, h_idx, pos] = new
        return self

    def read_raw(self, layer: int, span: Optional[int] = None,
                 start: int = 0):
        """Views (no copy) of a layer's positions [start, span): codes
        [B, H, span - start, D] and scales [B, H, span - start], as (k,
        k_scale, v, v_scale); the scales are None when unquantized."""
        return self._read(layer, slice(None), span, start)

    def read_raw_slot(self, layer: int, slot: int,
                      span: Optional[int] = None, start: int = 0):
        """:meth:`read_raw` of one slot (views [1, H, span - start, D] and
        [1, H, span - start]): a prefill chunk's queries attend to their
        own slot's history only."""
        return self._read(layer, slice(slot, slot + 1), span, start)

    def _read(self, layer: int, rows: slice, span: Optional[int],
              start: int):
        sl = slice(start, span)

        def view(buf):
            return None if buf is None else buf[layer, rows, :, sl]

        return (view(self.k), view(self.k_scale), view(self.v),
                view(self.v_scale))

    def read(self, layer: int, span: Optional[int] = None, start: int = 0):
        """Dequantized K and V of a layer's positions [start, span):
        [B, span - start, H, D] each in the cache's dtype, token-major (the
        :func:`~..models.layers.gqa_attention` operand layout); an
        unquantized cache's values as they are. The JAX package's
        compatibility read: the decode path reads :meth:`read_raw`."""
        k, ks, v, vs = self._read(layer, slice(None), span, start)
        if self.quantized:
            k = (k.to(torch.float32) * (ks[..., None] / 127.0)).to(self.dtype)
            v = (v.to(torch.float32) * (vs[..., None] / 127.0)).to(self.dtype)
        return k.transpose(1, 2), v.transpose(1, 2)

    def reset_slot(self, slot: int) -> "KVCache":
        """Set ``slot``'s length to 0 (in place)."""
        return self.set_length(slot, 0)

    def set_length(self, slot: int, length: int) -> "KVCache":
        """Set ``slot``'s length (in place)."""
        self.lengths[slot] = length
        return self

    def bytes_per_token(self) -> int:
        l, _, h, _, d = self.k.shape
        scales = 2 * h * 4 if self.quantized else 0
        return l * (2 * h * d * self.k.element_size() + scales)
