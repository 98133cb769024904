"""Random packed NF4 weights drawn on the device from the run's seed.

The layout is the benchmark's own plain tree of tensors, which the
reference (``benchmark/reference``) reads as it is and which
:func:`harness.model.program_params` wraps for the program:

    {"embed": bf16 [V, H], "final_norm": bf16 [H],
     "lm_head": {"packed": uint8 [V, H/2], "absmax": f32 [V, H/64]},
     "layers": [{"input_norm", "post_attn_norm": bf16 [H],
                 "qkv_proj", "o_proj": {"packed", "absmax"},
                 "gateup_proj", "down_proj": {...}            (dense MLP)
                 or "router": bf16 [E, H],
                    "experts": [{"gateup_proj", "down_proj"}]  (MoE MLP)}]}

Rewritten from the smoke script's ``random_params`` (unit norms, a
normal(0, 0.02) router, fused q/k/v and gate/up rows in that order), with
the weights' statistics changed so that a comparison of served tokens
means something at 32 layers:

- each linear's weights are drawn normal and quantized to NF4 here, per
  64-block (absmax the block's largest magnitude, each weight the nearest
  of the codebook's 16 values), not drawn as uniform code bytes: uniform
  bytes give every weight the codebook's mean, +0.0235 of its absmax, a
  rank-one part that grows through the layers until every position emits
  the same token (the first chip runs of this benchmark served one
  distinct token);
- the projections that write into the residual stream (``o_proj``,
  ``down_proj``) take GPT-2's scaled init, ``initializer_range /
  sqrt(2 * num_hidden_layers)``, the others ``initializer_range``, and
  the embedding is normal(0, 1): at ``initializer_range`` everywhere, 32
  layers of these widths amplify rounding chaotically (a bf16 run and its
  float32 reference then disagree on most argmaxes, as much as an int4
  run does), and no limit could tell a sound server from a broken one.

Everything is drawn on the device in a few large calls over one buffer
per kind (each leaf a 256-aligned view, absmax block i describing code
bytes [32 i, 32 i + 32)), so set-up does not pay for hundreds of small
draws; NF4 codes do not depend on the scale, so the leaves' absmax are
scaled afterwards. NF4 codes pack two per byte, element 2j in the low
nibble (the format's layout).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

BLOCKSIZE = 64
ALIGN = 256
CHUNK = 1 << 28          # weights drawn and quantized per call
RESIDUAL = ("o_proj", "down_proj")      # write into the residual stream
NF4 = (-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
       -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
       0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
       0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
       0.7229568362236023, 1.0)


def linear_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """(N, K) of each fused linear of a layer, the experts' included."""
    h, d = cfg["hidden_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    i = cfg["intermediate_size"]
    return {"qkv_proj": (nq + 2 * nkv, h), "o_proj": (h, nq),
            "gateup_proj": (2 * i, h), "down_proj": (h, i)}


def _leaves(cfg: dict) -> List[Tuple[tuple, Tuple[int, int]]]:
    """(path, (N, K)) of every NF4 linear, in drawing order."""
    shapes = linear_shapes(cfg)
    out = []
    for li in range(cfg["num_hidden_layers"]):
        out += [(("layers", li, n), shapes[n]) for n in ("qkv_proj", "o_proj")]
        mlp = [(n, shapes[n]) for n in ("gateup_proj", "down_proj")]
        if cfg["num_local_experts"]:
            for e in range(cfg["num_local_experts"]):
                out += [(("layers", li, "experts", e, n), s) for n, s in mlp]
        else:
            out += [(("layers", li, n), s) for n, s in mlp]
    out.append((("lm_head",), (cfg["vocab_size"], cfg["hidden_size"])))
    return out


def _round(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def nf4_fill_(codes: torch.Tensor, absmax: torch.Tensor, std: float,
              gen: torch.Generator) -> None:
    """Fill flat ``codes`` (uint8, 32 bytes a block) and ``absmax`` (f32,
    one a block) with normal(0, ``std``) weights quantized to NF4, in
    chunks of :data:`CHUNK` weights."""
    dev = codes.device
    book = torch.tensor(NF4, dtype=torch.float32, device=dev)
    mids = (book[1:] + book[:-1]) / 2
    per = CHUNK // BLOCKSIZE
    for b0 in range(0, absmax.numel(), per):
        nb = min(per, absmax.numel() - b0)
        w = torch.randn((nb, BLOCKSIZE), generator=gen, device=dev)
        w.mul_(std)
        a = w.abs().amax(dim=1).clamp_(min=1e-12)
        idx = torch.bucketize(w.div_(a[:, None]), mids, out_int32=True)
        idx = idx.to(torch.uint8)
        codes[b0 * 32:(b0 + nb) * 32].view(nb, 32).copy_(
            idx[:, 0::2] | (idx[:, 1::2] << 4))
        absmax[b0:b0 + nb].copy_(a)
        del w, idx, a


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The tree above for ``cfg`` (a configuration file's dict with
    ``head_dim`` and ``num_local_experts`` filled in), drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    leaves = _leaves(cfg)
    n_bytes = sum(_round(n * k // 2) for _, (n, k) in leaves)
    codes = torch.empty((n_bytes,), dtype=torch.uint8, device=device)
    absmax = torch.empty((n_bytes // 32,), dtype=torch.float32,
                         device=device)
    nf4_fill_(codes, absmax, 1.0, gen)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    n_layers, n_exp = cfg["num_hidden_layers"], cfg["num_local_experts"]
    std = cfg.get("initializer_range", 0.02)
    std_out = std / (2 * n_layers) ** 0.5
    embed = torch.randn((v, h), generator=gen, device=device).to(
        torch.bfloat16)
    router = None
    if n_exp:
        router = (torch.randn((n_layers, n_exp, h), generator=gen,
                              device=device).mul_(0.02).to(torch.bfloat16))
    ones = torch.ones((h,), dtype=torch.bfloat16, device=device)
    tree = {"embed": embed, "final_norm": ones,
            "layers": [{"input_norm": ones, "post_attn_norm": ones}
                       for _ in range(n_layers)]}
    for li in range(n_layers):
        if n_exp:
            tree["layers"][li]["router"] = router[li]
            tree["layers"][li]["experts"] = [{} for _ in range(n_exp)]
    ob = 0
    for path, (n, k) in leaves:
        leaf = {"packed": codes[ob:ob + n * k // 2].view(n, k // 2),
                "absmax": absmax[ob // 32:ob // 32 + n * k // BLOCKSIZE]
                .view(n, k // BLOCKSIZE)}
        ob += _round(n * k // 2)
        leaf["absmax"].mul_(std_out if path[-1] in RESIDUAL else std)
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree

