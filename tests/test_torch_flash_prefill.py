"""PyTorch port vs JAX package: causal prefill attention at S >= 1024.

Half precision: the port's plain version of kernel K3 at the TPU kernel's
512-key tile against JAX's ``flash_prefill_attention`` (its Pallas kernel in
interpret mode on the CPU), both bf16, within 1e-2 of max|ref| and cosine >
0.999, the bound of the JAX package's own kernel test: bf16 products and
f32 sums in both, but p is rounded to bf16 after exps that the two
libraries round differently. f32: the port's route off the kernel
(``tiled_attention`` at JAX's 512 blocks) against JAX's scan in
``gqa_attention_flash`` within 1e-5 (the same f32 arithmetic up to sum
order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.models import layers as JLay
from tpu_bitsandbytes.ops import flash_prefill as JFP
from tpu_bitsandbytes_torch.models import layers as TLay
from tpu_bitsandbytes_torch.ops import flash_prefill as TFP

from test_torch_functional import rel_err, t32


def _qkv(b, s, h, h_kv, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d))]


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("h,h_kv,s_real,opts", [
    (2, 2, 1024, {}),
    (4, 1, 1000, {}),
    (4, 1, 1024, {"window": 300}),
    (2, 2, 1024, {"softcap": 50.0}),
])
def test_plain_matches_jax_kernel(h, h_kv, s_real, opts):
    q, k, v = _qkv(1, 1024, h, h_kv, 128, seed=h * 7 + s_real)
    scale = 1.0 / np.sqrt(128)
    ref = JFP.flash_prefill_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), s_real=s_real,
        scale=scale, **opts)
    got = TFP.flash_prefill_plain(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
        s_real=s_real, scale=scale, block_k=512, **opts)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    # query rows at or past s_real are padding the caller drops
    ref = np.asarray(ref, np.float32)[:, :s_real]
    got = t32(got)[:, :s_real]
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


@pytest.mark.parametrize("h,h_kv,s_real,opts", [
    (2, 2, 1024, {}),
    (4, 1, 1000, {"window": 300}),
    (2, 2, 1024, {"softcap": 50.0}),
])
def test_plain_at_kernel_tile_matches_jax_kernel(h, h_kv, s_real, opts):
    """What CPU tensors run, and what the card's K3 computes: the plain
    version at the kernel's key tile (``KEY_TILE``), against JAX's kernel at
    its 512 tile, within the same bound (p rounds to bf16 at other tile
    edges: another running max when it rounds)."""
    q, k, v = _qkv(1, 1024, h, h_kv, 128, seed=h * 11 + s_real)
    scale = 1.0 / np.sqrt(128)
    ref = JFP.flash_prefill_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), s_real=s_real,
        scale=scale, **opts)
    got = TFP.flash_prefill_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
        s_real=s_real, scale=scale, **opts)
    ref = np.asarray(ref, np.float32)[:, :s_real]
    got = t32(got)[:, :s_real]
    assert TFP.KEY_TILE[128] == 128
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


@pytest.mark.parametrize("opts", [{}, {"window": 300, "softcap": 50.0}])
def test_f32_scan_matches_jax(opts):
    q, k, v = _qkv(2, 1100, 4, 2, 64, seed=5)
    ref = JLay.gqa_attention_flash(*(jnp.asarray(t) for t in (q, k, v)),
                                   **opts)
    got = TLay.gqa_attention_flash(*(torch.from_numpy(t) for t in (q, k, v)),
                                   **opts)
    assert rel_err(t32(got), np.asarray(ref)) <= 1e-5


def test_gqa_attention_dispatch_at_1024(monkeypatch):
    """Aligned prefills of 1024 tokens or more leave the dense einsum and
    route as the JAX package routes: bf16 at d = 128 goes to K3's wrapper
    (its plain version at the kernel's tile on the CPU), bf16 at d = 64
    (no multiple of 128, so JAX runs its scan) and f32 go to
    ``tiled_attention`` at 512 blocks, not through K3's wrapper; below 1024
    the dense path runs. All agree with the dense f32 attention within
    bf16 rounding."""
    tiles, scans = [], []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a, **kw: tiles.append(kw["block_k"])
                        or plain(*a, **kw))
    tiled = TLay.tiled_attention
    monkeypatch.setattr(TLay, "tiled_attention",
                        lambda *a, **kw: scans.append(kw["block_k"])
                        or tiled(*a, **kw))
    for d, k3 in ((128, True), (64, False)):
        tiles.clear(), scans.clear()
        q, k, v = (torch.from_numpy(t)
                   for t in _qkv(1, 1024, 2, 1, d, seed=9))
        got = TLay.gqa_attention(*(t.to(torch.bfloat16) for t in (q, k, v)))
        assert (tiles, scans) == (([TFP.KEY_TILE[d]], []) if k3
                                  else ([], [512]))
        assert TLay.jax_takes_its_kernel(1024, d) == k3
        f32 = TLay.gqa_attention(q, k, v)
        short = TLay.gqa_attention(q[:, :1000], k[:, :1000], v[:, :1000])
        assert tiles == ([TFP.KEY_TILE[d]] if k3 else [])
        assert scans == ([512] if k3 else [512, 512])
        assert rel_err(t32(got), t32(f32)) <= 1e-2
        assert rel_err(t32(short), t32(f32)[:, :1000]) <= 1e-5


def test_head_dim_64_matches_jax_scan():
    """d = 64 at S = 1024, half precision: the port's scan against JAX's
    ``gqa_attention_flash`` (its scan, since d is no multiple of 128), on
    the same inputs within the half-precision bound above."""
    q, k, v = _qkv(1, 1024, 4, 2, 64, seed=64)
    got = TLay.gqa_attention_flash(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    ref = JLay.gqa_attention_flash(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got, ref = t32(got), np.asarray(ref, np.float32)
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


@pytest.mark.parametrize("d", [96, 384])
def test_unkernelled_head_dims_take_the_scan(monkeypatch, d):
    """Half-precision head dims where neither K3 nor JAX's kernel runs (d
    not a multiple of 128, or above 256) leave K3's wrapper for the JAX
    package's scan (``tiled_attention`` at its 512 blocks), on the CPU as
    on the card, and agree with JAX's ``gqa_attention_flash`` on the same
    inputs within the half-precision bound above."""
    q, k, v = _qkv(1, 1024, 2, 1, d, seed=d)
    k3, scan = [], []
    monkeypatch.setattr(TLay, "flash_prefill_attention",
                        lambda *a, **kw: k3.append(1))
    tiled = TLay.tiled_attention
    monkeypatch.setattr(TLay, "tiled_attention",
                        lambda *a, **kw: scan.append(kw["block_k"])
                        or tiled(*a, **kw))
    got = TLay.gqa_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert not k3 and scan == [512]
    ref = JLay.gqa_attention_flash(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got, ref = t32(got), np.asarray(ref, np.float32)
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


@pytest.mark.parametrize("s,kernel", [(1024, True), (5632, True),
                                      (6144, False), (500, False)])
def test_head_dim_256_routes_as_jax(monkeypatch, s, kernel):
    """At d = 256 half precision goes to K3's wrapper exactly where JAX runs
    its kernel (S from 512 while the 512-padded S fits its budget: 5632 is
    the last), and to the scan elsewhere. JAX's own rule is asked as on a
    TPU."""
    monkeypatch.setattr(JFP.jax, "default_backend", lambda: "tpu")
    s_pad = -(-s // 512) * 512
    assert kernel == (s >= 512 and JFP.flash_prefill_supported(
        1, s, 1, 1, 256, jnp.bfloat16, s_pad))
    monkeypatch.undo()
    calls = []
    monkeypatch.setattr(TLay, "flash_prefill_attention",
                        lambda *a, **kw: calls.append("k3"))
    monkeypatch.setattr(TLay, "tiled_attention",
                        lambda *a, **kw: calls.append("scan"))
    q = torch.zeros((1, s, 1, 256), dtype=torch.bfloat16)
    TLay.gqa_attention_flash(q, q, q)
    assert calls == ["k3" if kernel else "scan"]
    assert TLay.jax_takes_its_kernel(s, 256) == kernel


def test_head_dim_256_matches_jax():
    """d = 256 at S = 1024 on the CPU: K3's plain version at the kernel's
    tile against JAX's ``gqa_attention_flash``, within the bound above."""
    q, k, v = _qkv(1, 1024, 2, 1, 256, seed=256)
    got = TLay.gqa_attention_flash(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    ref = JLay.gqa_attention_flash(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    got, ref = t32(got), np.asarray(ref, np.float32)
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


@pytest.mark.parametrize("s,h,h_kv,opts", [
    (1024, 4, 1, {"window": 300, "softcap": 50.0}),
    (600, 2, 2, {}),
])
def test_plain_at_head_dim_256_tile_matches_jax(monkeypatch, s, h, h_kv,
                                                opts):
    """d = 256, where K3 takes 64-key tiles: the CPU runs K3's plain
    version at that tile (p rounds to bf16 every 64 keys, as on the card)
    and agrees with JAX's ``gqa_attention_flash`` on the same inputs within
    the half-precision bound above, GQA, window and softcap included."""
    q, k, v = _qkv(1, s, h, h_kv, 256, seed=s + h)
    tiles = []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a, **kw: tiles.append(kw["block_k"])
                        or plain(*a, **kw))
    got = TLay.gqa_attention_flash(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), **opts)
    assert tiles == [TFP.KEY_TILE[256]] == [64]
    ref = JLay.gqa_attention_flash(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), **opts)
    got, ref = t32(got), np.asarray(ref, np.float32)
    assert rel_err(got, ref) <= 1e-2
    assert _cos(got, ref) > 0.999


def test_kept_pairs_counts_the_masks():
    for s, s_real, window in [(64, 64, None), (64, 50, None), (64, 64, 10),
                              (100, 37, 5)]:
        qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
        keep = (kpos <= qpos) & (kpos < s_real)
        if window is not None:
            keep &= kpos > qpos - window
        assert TFP.kept_pairs(s, s_real, window) == int(keep.sum())
