"""The plain reference: a Mistral-family decoder (Mistral-7B, Mixtral-8x7B)
in float32 PyTorch, teacher-forced over a prompt and the tokens a server
emitted for it (``reference/<model_type>.py`` is a configuration's
reference; ``mixtral.py`` is this decoder with its MoE MLP). It imports nothing of the port or of JAX and takes none of
the port's tensors: it reads the benchmark's own weights (NF4 codes and
absmax, embedding, norms, router) and works out again, at the precision
the configuration states, whatever the port derives from them:

- ``weights``: the NF4 values (the published codebook times the block's
  absmax); with ``runtime_cache: "int4"``, the int4 runtime cache the
  configuration serves from them: symmetric int4 per (row, 128-block),
  scale absmax / 7, round half to even, clip to +-7;
- ``decode_activations``: a decode step's matmul inputs quantized per row
  (scale rowmax|x| / qmax, qmax 127 for int8), as the decode kernels take
  them; a prefill's inputs stay unquantized (a prefill of at least 128
  prompt tokens is a product of over 64 rows, which the port computes
  without the decode kernels);
- ``kv_cache``: K and V quantized per (token, head) over the head's
  dimension (scale absmax / qmax) where a decode step reads them; a
  prefill attends to its own unquantized K and V.

Everything else is float32 (TF32 off): RMSNorm, rotary embedding in the
rotate-half layout, causal grouped-query attention inside the sliding
window, SiLU-gated MLPs, and Mixtral's router (softmax over the experts,
the top k renormalized; ties go to the lower index).

The layers run one at a time over every sequence, queries in blocks, so
that the reference fits beside the weights once the server is freed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

NF4 = (-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
       -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
       0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
       0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
       0.7229568362236023, 1.0)

BITS = {"int8": 8, "int4": 4, None: None}
QUERY_BLOCK = 512


def nf4_weight(leaf: dict) -> torch.Tensor:
    """f32 [N, K] of an NF4 leaf: codes [N, K/2] (element 2j in the low
    nibble), absmax [N, K/64]."""
    codes = leaf["packed"]
    n = codes.shape[0]
    idx = torch.stack([codes & 0x0F, codes >> 4], dim=-1).reshape(n, -1)
    book = torch.tensor(NF4, dtype=torch.float32, device=codes.device)
    w = book[idx.long()]
    nb = leaf["absmax"].shape[1]
    return (w.reshape(n, nb, -1) * leaf["absmax"].float()[:, :, None]
            ).reshape(n, -1)


def int4_cache(w: torch.Tensor, block: int = 128) -> torch.Tensor:
    """w rounded to symmetric int4 per (row, block)."""
    n, k = w.shape
    wb = w.reshape(n, k // block, block)
    s = wb.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 7.0
    return (torch.clamp(torch.round(wb / s), -7, 7) * s).reshape(n, k)


def quant_rows(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """x rounded per row (last dimension) to symmetric ``bits``-bit
    integers times rowmax|x| / qmax; None leaves x as it is."""
    if bits is None:
        return x
    qmax = 2 ** (bits - 1) - 1
    s = (x.abs().amax(dim=-1, keepdim=True) / qmax).clamp(min=1e-12)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def quant_kv(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """K or V [T, H_kv, D] rounded per (token, head) to ``bits`` bits."""
    if bits is None:
        return x
    qmax = 2 ** (bits - 1) - 1
    a = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8)
    return torch.clamp(torch.round(x * (qmax / a)), -qmax, qmax) * (a / qmax)


class Precision:
    """The precision the configuration states (its ``precision`` block),
    or a lower one for the control."""

    def __init__(self, spec: dict):
        self.cache = spec.get("runtime_cache")
        self.act_bits = BITS[spec.get("decode_activations")]
        self.kv_bits = BITS[spec.get("kv_cache")]

    def weight(self, leaf: dict) -> torch.Tensor:
        w = nf4_weight(leaf)
        return int4_cache(w) if self.cache == "int4" else w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x [T, H, D] at positions [T]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, kq, vq, n_prompt: int, window: Optional[int]):
    """Causal GQA of q [T, H, D] over k, v [T, H_kv, D]: queries before
    ``n_prompt`` (the prefill) read k, v; later ones (decode steps) read
    kq, vq, the cache's rounding of them."""
    t, h, d = q.shape
    rep = h // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    starts = sorted({0, n_prompt, t} | set(range(0, t, QUERY_BLOCK)))
    for a, b in zip(starts[:-1], starts[1:]):
        if a >= b:
            continue
        lo = 0 if window is None else max(0, a - window + 1)
        kk, vv = (k, v) if a < n_prompt else (kq, vq)
        kk = kk[lo:b].repeat_interleave(rep, dim=1)      # [S, H, D]
        vv = vv[lo:b].repeat_interleave(rep, dim=1)
        s = torch.einsum("thd,shd->hts", q[a:b], kk) * scale
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(lo, b, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = s.masked_fill(~keep[None], float("-inf"))
        out[a:b] = torch.einsum("hts,shd->thd", torch.softmax(s, -1), vv)
    return out


def _mm(x, w):
    return x @ w.t()


def _q(x: torch.Tensor, dec: torch.Tensor, bits) -> torch.Tensor:
    """x with its decode rows (``dec``) quantized per row to ``bits``."""
    if bits is None or not bool(dec.any()):
        return x
    return torch.where(dec[:, None], quant_rows(x, bits), x)


def _mlp(gu: torch.Tensor, down: torch.Tensor, h: torch.Tensor,
         dec: torch.Tensor, bits) -> torch.Tensor:
    g, u = _mm(_q(h, dec, bits), gu).chunk(2, dim=-1)
    return _mm(_q(torch.nn.functional.silu(g) * u, dec, bits), down)


def _moe(lw: dict, experts: list, h: torch.Tensor, dec: torch.Tensor,
         bits, top_k: int) -> torch.Tensor:
    """Mixtral's MLP: each token through its top-k experts by the f32
    router, weighted by the renormalized softmax."""
    probs = torch.softmax(_mm(h, lw["router"].float()), dim=-1)
    top = torch.argsort(-probs, dim=-1, stable=True)[:, :top_k]
    wts = probs.gather(1, top)
    wts = wts / wts.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e, (gu, down) in enumerate(experts):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel():
            y = _mlp(gu, down, h[rows], dec[rows], bits)
            out.index_add_(0, rows, y * wts[rows, slot][:, None])
    return out


def forward_logits(tree: dict, cfg: dict, spec: dict,
                   seqs: Sequence[Tuple[List[int], List[int]]],
                   kv_sink: Optional[Callable] = None
                   ) -> List[torch.Tensor]:
    """For each (prompt, served) pair, f32 logits [len(served), V] at the
    positions that chose the served tokens: the prompt's last position
    (the prefill's first token), then each decode step, whose input is
    the previous served token. ``spec``: the precision block.
    ``kv_sink``: called as ``kv_sink(layer, j, k, v)`` with sequence j's
    f32 K (rotated) and V [T, H_kv, D] at every layer, before the cache's
    rounding."""
    prec = Precision(spec)
    bits = prec.act_bits
    dev = tree["embed"].device
    d = cfg["head_dim"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    window = cfg.get("sliding_window")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ids = [torch.tensor(p + s[:-1], device=dev) for p, s in seqs]
        n_p = [len(p) for p, _ in seqs]
        sizes = [len(i) for i in ids]
        dec = torch.cat([torch.arange(t, device=dev) >= n
                         for t, n in zip(sizes, n_p)])
        x = torch.cat([tree["embed"][i].float() for i in ids])
        for li, lw in enumerate(tree["layers"]):
            wqkv, wo = prec.weight(lw["qkv_proj"]), prec.weight(lw["o_proj"])
            h = rms_norm(x, lw["input_norm"], eps)
            qkv = _mm(_q(h, dec, bits), wqkv)
            att = []
            for j, (q, k, v) in enumerate(zip(
                    *(t.split(sizes) for t in
                      qkv.split([nh * d, nkv * d, nkv * d], dim=-1)))):
                t = sizes[j]
                pos = torch.arange(t, device=dev)
                q = rope(q.reshape(t, nh, d), pos, theta)
                k = rope(k.reshape(t, nkv, d), pos, theta)
                v = v.reshape(t, nkv, d)
                if kv_sink is not None:
                    kv_sink(li, j, k, v)
                att.append(attention(q, k, v, quant_kv(k, prec.kv_bits),
                                     quant_kv(v, prec.kv_bits), n_p[j],
                                     window).reshape(t, nh * d))
            x = x + _mm(_q(torch.cat(att), dec, bits), wo)
            del wqkv, wo, qkv, att
            h = rms_norm(x, lw["post_attn_norm"], eps)
            if "experts" in lw:
                experts = [(prec.weight(e["gateup_proj"]),
                            prec.weight(e["down_proj"]))
                           for e in lw["experts"]]
                x = x + _moe(lw, experts, h, dec, bits,
                             cfg["num_experts_per_tok"])
            else:
                experts = [(prec.weight(lw["gateup_proj"]),
                            prec.weight(lw["down_proj"]))]
                x = x + _mlp(*experts[0], h, dec, bits)
            del experts
        head = prec.weight(tree["lm_head"])
        out = []
        for j, xj in enumerate(x.split(sizes)):
            hj = rms_norm(xj[n_p[j] - 1:], tree["final_norm"], eps)
            dj = torch.arange(hj.shape[0], device=dev) > 0
            out.append(_mm(_q(hj, dj, bits), head))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each chosen token's reference logit lies below the
    reference's best at its position."""
    return ref.max(dim=-1).values - ref.gather(1, tokens[:, None])[:, 0]


def compare(ref: List[torch.Tensor], served: List[List[int]],
            other: Optional[List[torch.Tensor]] = None) -> Dict[str, float]:
    """The served tokens' (or, given ``other``, its argmax tokens') gaps
    below the reference's best: the widest, the mean and the share of
    tokens that are not the reference's argmax."""
    all_gaps = []
    for j, r in enumerate(ref):
        toks = (other[j].argmax(dim=-1) if other is not None else
                torch.tensor(served[j], device=r.device))
        all_gaps.append(gaps(r, toks))
    g = torch.cat(all_gaps).double()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "not_argmax": float((g > 0).double().mean()),
            "tokens": int(g.numel())}
