"""Transformer building blocks with quantized weights, in PyTorch.

Model parameters are plain dicts of tensors plus :class:`QLinear4` leaves,
as in the JAX package, and every public function keeps the JAX package's
layouts: activations ``[B, S, H, D]``, KV codes head-major
``[B, H_kv, T, D]``, int4-cache scales ``[nb, N]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..functional import (QuantState, _pad_k, dequantize_4bit,
                          dequantize_blockwise, div_exact, matmul_4bit,
                          quantize_4bit, quantize_blockwise)
from ..ops.flash_prefill import flash_prefill_attention, tiled_attention
from ..ops.int4cache import int4_matmul, quantize_int4
from ..ops.w4a8 import takes_w4a8, w4a8_matmul_4bit

FLASH_PREFILL_THRESHOLD = 1024
_SCAN_BLOCK = 512   # query and key block of the f32 flash route


@dataclasses.dataclass
class QLinear4:
    """4-bit quantized linear weight.

    ``packed`` [N, K_pad/2] uint8 NF4/FP4 nibble pairs and ``absmax``
    [N, nb] (or ``absmax_q`` int8 with the nested ``absmax_state`` when the
    statistics are double-quantized). ``w_cache``/``cache_scale`` hold a
    runtime cache, told apart by the cache's dtype: the int4 cache (uint8
    [N, K_pad/2] two's-complement nibble pairs, f32 [K_pad/128, N]) that
    decode streams through kernel K1; the int8 cache (int8 [N, K], f32 row
    scale [N]) or the bf16 cache ([N, K], no scale), which run the JAX
    package's dot (an XLA fusion there, plain torch here). Without a cache
    the layer runs off the packed bytes: kernel K4 where the JAX package
    takes its W4A8 kernel, else :func:`matmul_4bit` (K5 up to M = 256).
    """

    packed: Optional[torch.Tensor]
    absmax: Optional[torch.Tensor]
    shape: Tuple[int, int]
    blocksize: int = 64
    quant_type: str = "nf4"
    dtype: torch.dtype = torch.bfloat16
    bias: Optional[torch.Tensor] = None
    absmax_q: Optional[torch.Tensor] = None
    absmax_state: Optional[QuantState] = None
    w_cache: Optional[torch.Tensor] = None
    cache_scale: Optional[torch.Tensor] = None

    @classmethod
    def quantize(cls, w: torch.Tensor, blocksize: int = 64,
                 quant_type: str = "nf4", dtype=torch.bfloat16,
                 bias: Optional[torch.Tensor] = None,
                 compress_statistics: bool = False) -> "QLinear4":
        """Quantize a float weight [N, K]. With ``compress_statistics`` the
        absmax is double-quantized one row per int8 block, so the
        compressed scales shard like the rows."""
        n, k = w.shape
        packed_flat, state = quantize_4bit(w, blocksize=blocksize,
                                           quant_type=quant_type)
        kp = _pad_k(k, blocksize)
        nb = kp // blocksize
        packed = packed_flat.reshape(n, kp // 2)
        if compress_statistics:
            absmax_q, st2 = quantize_blockwise(state.absmax.reshape(n, nb),
                                               blocksize=nb)
            return cls(packed=packed, absmax=None, shape=(n, k),
                       blocksize=blocksize, quant_type=quant_type,
                       dtype=dtype, bias=bias, absmax_q=absmax_q,
                       absmax_state=st2)
        return cls(packed=packed, absmax=state.absmax.reshape(n, nb),
                   shape=(n, k), blocksize=blocksize, quant_type=quant_type,
                   dtype=dtype, bias=bias)

    def materialize_absmax(self) -> torch.Tensor:
        if self.absmax is not None:
            return self.absmax
        n, nb = self.absmax_q.shape
        flat = dequantize_blockwise(self.absmax_q.reshape(-1),
                                    self.absmax_state)
        return flat.reshape(n, nb)

    def quant_state(self) -> QuantState:
        return QuantState(absmax=self.materialize_absmax().reshape(-1),
                          shape=tuple(self.shape), blocksize=self.blocksize,
                          quant_type=self.quant_type, dtype=self.dtype)

    def with_runtime_cache(self, fmt: str = "int8",
                           drop_packed: bool = False) -> "QLinear4":
        """Attach a runtime cache of the NF4 weight, dequantized in f32:
        "int8", symmetric int8 per output row (scale max|w| / 127);
        "int4", symmetric int4 per (row, 128-block); "bf16", the weight
        itself. ``drop_packed`` frees the NF4 codes and absmax."""
        state = dataclasses.replace(self.quant_state(), dtype=torch.float32)
        w = dequantize_4bit(self.packed.reshape(-1), state)
        if fmt == "bf16":
            cache, scale = w.to(torch.bfloat16), None
        elif fmt == "int8":
            s = div_exact(w.abs().amax(dim=1).clamp(min=1e-8), 127.0)
            cache = torch.clamp(torch.round(w / s[:, None]), -127, 127
                                ).to(torch.int8)
            scale = s
        elif fmt == "int4":
            cache, scale = quantize_int4(w)
        else:
            raise ValueError(f"unknown runtime cache format: {fmt!r}")
        keep = not drop_packed
        return dataclasses.replace(
            self, w_cache=cache, cache_scale=scale,
            packed=self.packed if keep else None,
            absmax=self.absmax if keep else None,
            absmax_q=self.absmax_q if keep else None,
            absmax_state=self.absmax_state if keep else None)

    def hbm_bytes(self) -> int:
        """Device-memory bytes one forward pass reads for the weight."""
        if self.w_cache is not None:
            b = self.w_cache.numel() * self.w_cache.element_size()
            if self.cache_scale is not None:
                b += self.cache_scale.numel() * 4
            return b
        b = self.packed.numel()
        if self.absmax is not None:
            b += self.absmax.numel() * 4
        elif self.absmax_q is not None:
            b += self.absmax_q.numel() + self.absmax_state.absmax.numel() * 4
        if self.bias is not None:
            b += self.bias.numel() * self.bias.element_size()
        return b

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        n = self.shape[0]
        if self.w_cache is not None and self.w_cache.dtype == torch.uint8:
            # a row-parallel shard carries its tensor-parallel group
            # (parallel.tp): the A8 row scale is all-reduced over it
            out = int4_matmul(x2, self.w_cache, self.cache_scale,
                              bias=self.bias, out_dtype=self.dtype, n_out=n,
                              xmax_group=getattr(self, "_tp_group", None))
        elif self.w_cache is not None:
            out = cache_matmul(x2, self.w_cache, self.cache_scale,
                               self.bias, self.dtype)
        elif takes_w4a8(x2.shape[0], n, _pad_k(self.shape[1], self.blocksize),
                        self.blocksize, self.quant_type):
            out = w4a8_matmul_4bit(x2, self.packed.reshape(-1),
                                   self.quant_state(), bias=self.bias,
                                   out_dtype=self.dtype)
        else:
            out = matmul_4bit(x2, self.packed.reshape(-1), self.quant_state(),
                              bias=self.bias, compute_dtype=self.dtype)
        return out.reshape(*lead, n)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in f32, the JAX package's ``dot_general(...,
    preferred_element_type=float32)`` of x with ``w`` cast to x's dtype
    (``w``'s values must be exact in it: int8 codes, or a tensor of x's
    dtype): the product is never rounded to a half-precision type. On a
    card a half-precision x takes one GEMM with an f32 output (``mm``'s
    ``out_dtype``); elsewhere both operands are widened to f32 (exact)."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w.to(x.dtype).t(), out_dtype=torch.float32)
    return x.to(torch.float32) @ w.to(torch.float32).t()


def cache_matmul(x2: torch.Tensor, w_cache: torch.Tensor,
                 cache_scale: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 or bf16 runtime cache's product, as the JAX package's
    ``QLinear4.__call__`` computes it: the cache widened to x's dtype, an
    f32 product, times the f32 row scale, plus the bias in f32, cast once.
    JAX leaves this to an XLA fusion (no Pallas kernel), so it stays plain
    torch: the widened weight is a temporary the fusion does not write."""
    # int8 codes are exact in any float type; a bf16 cache rounds to x's
    # dtype, as JAX's astype does
    w = w_cache if w_cache.dtype == torch.int8 else w_cache.to(x2.dtype)
    out = dot_f32(x2, w)
    if cache_scale is not None:
        out = out * cache_scale[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def linear_apply(w, x: torch.Tensor) -> torch.Tensor:
    """Apply a weight leaf: a :class:`QLinear4` or a
    :class:`~tpu_bitsandbytes_torch.models.lora.LoRALinear` (callables), a
    dict with 'w' (and an optional 'b'), or a raw [N, K] tensor."""
    if callable(w) and not isinstance(w, torch.Tensor):
        return w(x)
    if isinstance(w, dict):
        out = x @ w["w"].t().to(x.dtype)
        if w.get("b") is not None:
            out = out + w["b"].to(out.dtype)
        return out
    return x @ w.t().to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0):
    """RMSNorm. The default (offset 0) casts the normalized activation back
    to x's dtype before the weight multiply (HF Llama's order); Gemma's
    zero-centered weights (``offset=1.0``) multiply by ``w + 1`` in f32,
    before the cast."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    if offset:
        w = weight.to(torch.float32) + offset
        return ((x32 * torch.rsqrt(var + eps)) * w).to(x.dtype)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """LayerNorm, normalized in f32, then weight and bias in x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight.to(x.dtype) + bias.to(x.dtype)


def rope_table(head_dim: int, max_seq: int, theta: float = 10000.0,
               scaling=None, *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables [max_seq, head_dim/2] f32. ``scaling``:
    ("linear", factor) or Llama-3.1's ("llama3", factor, low_freq_factor,
    high_freq_factor, orig_max_pos)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    if scaling is not None:
        if scaling[0] == "linear":
            inv_freq = inv_freq / scaling[1]
        elif scaling[0] == "llama3":
            _, factor, low_f, high_f, orig_max = scaling
            low_wavelen = orig_max / low_f
            high_wavelen = orig_max / high_f
            wavelen = 2 * np.pi / inv_freq
            scaled = inv_freq / factor
            smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
            mid = (1 - smooth) * scaled + smooth * inv_freq
            inv_freq = np.where(wavelen < high_wavelen, inv_freq,
                                np.where(wavelen > low_wavelen, scaled, mid))
        else:
            raise ValueError(f"unknown rope scaling: {scaling!r}")
    freqs = np.outer(np.arange(max_seq), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, D]; cos/sin [..., S, R/2] gathered at x's positions.
    R = 2 * cos.shape[-1] is the rotary dim: with R < D (partial rotary,
    Phi-2 and StableLM) the trailing D - R dims pass through."""
    d2 = cos.shape[-1]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., 2 * d2:]],
                     dim=-1)


def _causal_mask(s: int, t: int, causal_offset: Optional[torch.Tensor],
                 window: Optional[int] = None, kpos_start: int = 0,
                 ring: Optional[int] = None, device=None) -> torch.Tensor:
    """Causal (optionally sliding-window) keep-mask: [1,1,1,S,T] for an
    aligned prefill (``causal_offset`` None), else [B,1,1,S,T] with
    ``causal_offset`` [B, S] the queries' absolute positions and key index
    0 at absolute position ``kpos_start``. ``window``: a query at p sees
    keys in (p - window, p]. ``ring``: a rolling cache of ``ring`` entries,
    where key index r holds the last absolute position congruent to r
    modulo ``ring`` at or before the query's (unwritten entries, at
    negative positions, are masked); decode only."""
    if ring is not None:
        if causal_offset is None:
            raise ValueError("the ring mask needs causal_offset")
        r = torch.arange(t, device=causal_offset.device)[None, None, :]
        off = causal_offset[:, :, None].long()
        a = off - torch.remainder(off - r, ring)
        keep = a >= 0
        if window is not None:
            keep &= a > off - window
        return keep[:, None, None]
    if causal_offset is None:
        if kpos_start != 0:
            raise ValueError("kpos_start needs causal_offset")
        qpos = torch.arange(s, device=device)[:, None]
        kpos = torch.arange(t, device=device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        return keep[None, None, None]
    kpos = kpos_start + torch.arange(t, device=causal_offset.device)
    off = causal_offset[:, :, None]
    keep = kpos[None, None, :] <= off
    if window is not None:
        keep &= kpos[None, None, :] > off - window
    return keep[:, None, None]


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma2's logit soft-capping, cap * tanh(x / cap); None: as is."""
    return logits if cap is None else torch.tanh(logits / cap) * cap


def jax_takes_its_kernel(s: int, d: int) -> bool:
    """Whether the JAX package's ``gqa_attention_flash`` runs its Pallas
    kernel on half-precision q (its ``flash_prefill_supported``): head dims
    that are multiples of 128 up to 256, at 512-padded lengths whose K/V
    tiles, q/out blocks and f32 logits fit the kernel's 14 MiB budget."""
    if s < _SCAN_BLOCK or d % 128 or d > 256:
        return False
    s_pad = -(-s // _SCAN_BLOCK) * _SCAN_BLOCK
    vmem = (4 * s_pad * d * 2 + 4 * _SCAN_BLOCK * d * 2
            + _SCAN_BLOCK * _SCAN_BLOCK * 4 + 2 * _SCAN_BLOCK * d * 4)
    return vmem <= 14 * 2 ** 20


def gqa_attention_flash(q, k, v, *, scale=None, window=None, softcap=None):
    """Causal GQA for aligned prefill (S == T) in O(S) memory.

    Half-precision q runs :func:`flash_prefill_attention` (kernel K3)
    exactly where the JAX package runs its kernel
    (:func:`jax_takes_its_kernel`: d = 128 up to a 512-padded S of 12,288,
    d = 256 up to S = 5632, which K3 takes with 64-key tiles). Everything
    else, d = 64 included, runs the JAX package's own non-kernel route, its
    scan: the same online softmax in torch ops over 512 x 512 blocks
    (:func:`tiled_attention`), in f32 with p rounded to v's dtype before
    the PV product.
    """
    s, d = q.shape[1], q.shape[3]
    if s != k.shape[1]:
        raise ValueError("flash path is for aligned causal prefill (S == T)")
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    if _half(q.dtype) and jax_takes_its_kernel(s, d):
        return flash_prefill_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), s_real=s,
                                       scale=float(scale), window=window,
                                       softcap=softcap)
    return tiled_attention(q, k, v, s_real=s, scale=float(scale),
                           window=window, softcap=softcap,
                           block_k=_SCAN_BLOCK)


def gqa_attention(q, k, v, *, causal_offset=None, scale=None, window=None,
                  softcap=None, kpos_start: int = 0, ring=None
                  ) -> torch.Tensor:
    """Dense grouped-query attention, computed in f32.

    q [B, S, H, D]; k/v [B, T, H_kv, D] token-major. ``causal_offset``
    [B, S]: the queries' absolute positions (None: aligned causal prefill,
    S == T). ``window``, ``kpos_start`` and ``ring``: see
    :func:`_causal_mask`; ``softcap`` caps the scaled logits. Aligned
    prefills of 1024 tokens or more go to :func:`gqa_attention_flash`, as in
    the JAX package.
    """
    b, s, h, d = q.shape
    t, h_kv = k.shape[1], k.shape[2]
    if (causal_offset is None and ring is None and kpos_start == 0
            and s == t and s >= FLASH_PREFILL_THRESHOLD):
        return gqa_attention_flash(q, k, v, scale=scale, window=window,
                                   softcap=softcap)
    rep = h // h_kv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, s, h_kv, rep, d).to(torch.float32)
    logits = torch.einsum("bshrd,bthd->bhrst", qg, k.to(torch.float32)) * scale
    logits = _softcap(logits, softcap)
    mask = _causal_mask(s, t, causal_offset, window, kpos_start, ring,
                        device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _half(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def gqa_attention_hm(q, k, v, *, causal_offset=None, scale=None,
                     window=None, softcap=None, kpos_start: int = 0,
                     ring=None) -> torch.Tensor:
    """GQA over head-major unquantized K/V (the bf16 KV cache's layout).

    q [B, S, H, D]; k/v [B, H_kv, T, D]. The JAX package's dtype policy:
    half-precision q contracts half-precision operands with f32
    accumulation (here: f32 products of the half values, which are exact)
    and rounds the probabilities to q's dtype before the PV product; f32
    stays f32. ``causal_offset`` [B, S]: the queries' absolute positions;
    ``window``, ``softcap``, ``kpos_start`` and ``ring`` as in
    :func:`gqa_attention`.
    """
    b, s, h, d = q.shape
    h_kv, t = k.shape[1], k.shape[2]
    rep = h // h_kv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    f32 = torch.float32
    cd = q.dtype if _half(q.dtype) else f32
    qg = q.reshape(b, s, h_kv, rep, d).to(f32)
    logits = torch.einsum("bshrd,bhtd->bhrst", qg,
                          k.to(cd).to(f32)) * scale
    logits = _softcap(logits, softcap)
    mask = _causal_mask(s, t, causal_offset, window, kpos_start, ring,
                        device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(cd).to(f32)
    out = torch.einsum("bhrst,bhtd->bshrd", probs, v.to(cd).to(f32))
    return out.reshape(b, s, h, d).to(q.dtype)


def gqa_attention_kv_quant(q, k_q, k_scale, v_q, v_scale, *,
                           causal_offset=None, scale=None, window=None,
                           softcap=None, kpos_start: int = 0, ring=None,
                           staged=None):
    """GQA directly over int8 head-major KV codes, accumulated in f32.

    q [B, S, H, D]; k_q/v_q int8 [B, H_kv, T, D]; k_scale/v_scale f32
    [B, H_kv, T] absmax scales. ``k_scale`` folds into the logits after
    QK^T and ``v_scale`` into the probabilities before PV, so no dequantized
    K/V is materialized. The JAX package's dtype policy: with half-precision
    q the operands are in q's dtype (int8 codes are exact there) and the
    scale-folded probabilities are rounded to it before the PV product;
    f32 q computes in f32. ``staged``: ``(st_k, st_ks, st_v, st_vs,
    step)``, the decode chunk's staged block (``KVCache.read_stage``),
    joined as a second key block: the main block is cut at the chunk start
    (``kpos <= off - step - 1``), staged key j counts when ``j <= step``,
    and one softmax covers both. Requires S == 1 and no ``ring`` (see
    :func:`_causal_mask`).
    """
    b, s, h, d = q.shape
    h_kv, t = k_q.shape[1], k_q.shape[2]
    rep = h // h_kv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    f32 = torch.float32
    cd = q.dtype if _half(q.dtype) else f32

    def rounded(pv):
        """The PV operand as the JAX package feeds it: in q's dtype."""
        return pv.to(cd).to(f32)

    qg = q.reshape(b, s, h_kv, rep, d).to(f32)
    logits = torch.einsum("bshrd,bhtd->bhrst", qg, k_q.to(f32))
    logits = logits * (k_scale * (scale / 127.0))[:, :, None, None, :]
    neg = torch.full((), -1e30, dtype=f32, device=q.device)
    if staged is not None:
        if s != 1 or ring is not None:
            raise ValueError("staged attention is decode-only (S == 1) "
                             "and takes no ring")
        st_k, st_ks, st_v, st_vs, step = staged
        c = st_k.shape[2]
        lg_st = torch.einsum("bshrd,bhtd->bhrst", qg, st_k.to(f32))
        lg_st = lg_st * (st_ks * (scale / 127.0))[:, :, None, None, :]
        logits, lg_st = _softcap(logits, softcap), _softcap(lg_st, softcap)
        kpos = kpos_start + torch.arange(t, device=q.device)[None, None, :]
        off = causal_offset[:, :, None]
        keep_main = kpos <= off - step - 1
        jst = torch.arange(c, device=q.device)[None, None, :]
        keep_st = (jst <= step).expand(b, 1, c)
        if window is not None:
            keep_main = keep_main & (kpos > off - window)
            keep_st = keep_st & (jst > step - window)
        logits = torch.where(keep_main[:, None, None], logits, neg)
        lg_st = torch.where(keep_st[:, None, None], lg_st, neg)
        m = torch.maximum(logits.amax(dim=-1, keepdim=True),
                          lg_st.amax(dim=-1, keepdim=True))
        pm = torch.exp(logits - m)
        pst = torch.exp(lg_st - m)
        denom = (pm.sum(dim=-1, keepdim=True)
                 + pst.sum(dim=-1, keepdim=True))
        vs = (v_scale / 127.0)[:, :, None, None, :]
        stvs = (st_vs / 127.0)[:, :, None, None, :]
        out = (torch.einsum("bhrst,bhtd->bshrd", rounded(pm * vs),
                            v_q.to(f32))
               + torch.einsum("bhrst,bhtd->bshrd", rounded(pst * stvs),
                              st_v.to(f32)))
        out = out / denom.permute(0, 3, 1, 2, 4)
        return out.reshape(b, s, h, d).to(q.dtype)
    logits = _softcap(logits, softcap)
    mask = _causal_mask(s, t, causal_offset, window, kpos_start, ring,
                        device=q.device)
    logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    pv = rounded(probs * (v_scale / 127.0)[:, :, None, None, :])
    out = torch.einsum("bhrst,bhtd->bshrd", pv, v_q.to(f32))
    return out.reshape(b, s, h, d).to(q.dtype)
