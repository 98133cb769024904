"""Quantized embeddings: 4-bit (NF4/FP4) and row-wise int8.

The whole table is quantized in one row-wise pass of
:func:`~..functional.quantize_4bit`; a lookup gathers the packed rows and
their absmax and decodes them (the JAX package's XLA gather and decode;
plain torch here, since JAX runs no Pallas kernel for it). Ids equal to
``padding_idx`` give zeros.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..functional import (_pad_k, codebook, div_exact, quantize_4bit,
                          quantize_rowwise, to_tensor, unpack_nibbles)
from .base import Module, compute_dtype_of, full_precision
from .linear import zero_padding


class Embedding4bit(Module):
    """4-bit embedding: ``weight_packed`` [V, D_pad/2] uint8 nibble pairs
    by row, ``weight_absmax`` [V, D_pad/blocksize] f32. An odd source
    width is stored padded by one column and sliced back on lookup
    (``logical_dim``)."""

    QUANTIZED_KEYS = ("weight_packed", "weight_absmax")
    OPTIONAL_KEYS = ("quant_meta",)

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, quant_type: str = "nf4",
                 blocksize: int = 64, device=None, dtype=torch.bfloat16,
                 logical_dim: Optional[int] = None):
        super().__init__()
        if quant_type not in ("nf4", "fp4"):
            raise ValueError(
                f"quant_type must be 'nf4' or 'fp4', got {quant_type}")
        if embedding_dim % 2 != 0:
            raise ValueError(f"embedding_dim must be even, got "
                             f"{embedding_dim}")
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.logical_dim = int(logical_dim or embedding_dim)
        self.padding_idx = padding_idx
        self.quant_type = quant_type
        self.blocksize = int(blocksize)
        self.dtype = dtype
        d_pad = _pad_k(embedding_dim, blocksize)
        self.register_buffer("weight_packed", torch.zeros(
            (num_embeddings, d_pad // 2), dtype=torch.uint8, device=device))
        self.register_buffer("weight_absmax", torch.ones(
            (num_embeddings, d_pad // blocksize), dtype=torch.float32,
            device=device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        flat = input.reshape(-1)
        packed = self.weight_packed[flat]
        absmax = self.weight_absmax[flat]
        vals = codebook(self.quant_type, packed.device)[
            unpack_nibbles(packed).long()]
        nb = absmax.shape[1]
        vals = (vals.reshape(-1, nb, self.blocksize)
                * absmax[:, :, None]).reshape(flat.shape[0], -1)
        out = vals[:, :self.logical_dim].to(self.dtype).reshape(
            *input.shape, self.logical_dim)
        return zero_padding(out, input, self.padding_idx)

    def _requantize(self, weight: torch.Tensor) -> None:
        """Quantize a float table [V, D] into this layer (odd D padded)."""
        v, d = weight.shape
        self.logical_dim = d
        if d % 2:
            weight = torch.nn.functional.pad(weight, (0, 1))
            d += 1
        self.num_embeddings, self.embedding_dim = v, d
        packed, state = quantize_4bit(weight, blocksize=self.blocksize,
                                      quant_type=self.quant_type)
        d_pad = _pad_k(d, self.blocksize)
        self.weight_packed = packed.reshape(v, d_pad // 2)
        self.weight_absmax = state.absmax.reshape(v, d_pad // self.blocksize)

    @classmethod
    def from_embedding(cls, embedding, quant_type: str = "nf4",
                       blocksize: int = 64, device=None) -> "Embedding4bit":
        """Quantize an Embedding-like module (``.weight`` [V, D]), on
        ``device`` or where its weight lies."""
        weight = to_tensor(embedding.weight).detach()
        weight = weight.to(weight.device if device is None else device)
        v, d = weight.shape
        layer = cls(v, d + d % 2, padding_idx=getattr(embedding,
                                                      "padding_idx", None),
                    quant_type=quant_type, blocksize=blocksize,
                    device=weight.device, dtype=compute_dtype_of(weight),
                    logical_dim=d)
        layer._requantize(weight)
        return layer

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        destination[prefix + "quant_meta"] = {
            "blocksize": self.blocksize, "quant_type": self.quant_type,
            "logical_dim": self.logical_dim,
            "embedding_dim": self.embedding_dim}

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_packed.device
        meta = state_dict.get(prefix + "quant_meta")
        if meta is not None:
            loaded_bs = int(meta.get("blocksize", 64))
            if loaded_bs != self.blocksize:
                warnings.warn(
                    f"Embedding4bit blocksize mismatch: layer has blocksize="
                    f"{self.blocksize}, checkpoint has blocksize={loaded_bs}."
                    f" Using checkpoint blocksize.", UserWarning)
                self.blocksize = loaded_bs
            loaded_qt = str(meta.get("quant_type", "nf4"))
            if loaded_qt != self.quant_type:
                warnings.warn(
                    f"Embedding4bit quant_type mismatch: layer has "
                    f"quant_type='{self.quant_type}', checkpoint has "
                    f"quant_type='{loaded_qt}'. Using checkpoint quant_type.",
                    UserWarning)
                self.quant_type = loaded_qt
            self.logical_dim = int(meta.get("logical_dim", self.logical_dim))
            self.embedding_dim = int(meta.get("embedding_dim",
                                              self.embedding_dim))
        w_key = prefix + "weight"
        if w_key in state_dict:
            self._requantize(full_precision(
                "Embedding4bit", w_key, to_tensor(state_dict[w_key], dev)))
        if prefix + "weight_packed" in state_dict:
            self.weight_packed = to_tensor(
                state_dict[prefix + "weight_packed"], dev, torch.uint8)
        if prefix + "weight_absmax" in state_dict:
            self.weight_absmax = to_tensor(
                state_dict[prefix + "weight_absmax"], dev, torch.float32)

    def extra_repr(self) -> str:
        return (f"{self.num_embeddings}, {self.embedding_dim}, "
                f"padding_idx={self.padding_idx}, "
                f"quant_type={self.quant_type}, blocksize={self.blocksize}")


class Embedding8bit(Module):
    """Row-wise int8 embedding: ``weight_int8`` [V, D], f32
    ``weight_scales`` [V] (row absmax)."""

    QUANTIZED_KEYS = ("weight_int8", "weight_scales")

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = padding_idx
        self.dtype = dtype
        self.register_buffer("weight_int8", torch.zeros(
            (num_embeddings, embedding_dim), dtype=torch.int8, device=device))
        self.register_buffer("weight_scales", torch.ones(
            (num_embeddings,), dtype=torch.float32, device=device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        rows = self.weight_int8[input].to(torch.float32)
        scales = div_exact(self.weight_scales[input], 127.0)
        out = (rows * scales[..., None]).to(self.dtype)
        return zero_padding(out, input, self.padding_idx)

    @classmethod
    def from_embedding(cls, embedding, device=None) -> "Embedding8bit":
        """Quantize an Embedding-like module, on ``device`` or where its
        weight lies."""
        weight = to_tensor(embedding.weight).detach()
        weight = weight.to(weight.device if device is None else device)
        layer = cls(weight.shape[0], weight.shape[1],
                    padding_idx=getattr(embedding, "padding_idx", None),
                    device=weight.device, dtype=compute_dtype_of(weight))
        layer.weight_int8, layer.weight_scales = quantize_rowwise(weight)
        return layer

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_int8.device
        w_key = prefix + "weight"
        if w_key in state_dict:
            w = full_precision("Embedding8bit", w_key,
                               to_tensor(state_dict[w_key], dev))
            self.weight_int8, self.weight_scales = quantize_rowwise(w)
            self.num_embeddings, self.embedding_dim = w.shape
        if prefix + "weight_int8" in state_dict:
            self.weight_int8 = to_tensor(state_dict[prefix + "weight_int8"],
                                         dev, torch.int8)
        if prefix + "weight_scales" in state_dict:
            self.weight_scales = to_tensor(
                state_dict[prefix + "weight_scales"], dev, torch.float32)

    def extra_repr(self) -> str:
        return (f"{self.num_embeddings}, {self.embedding_dim}, "
                f"padding_idx={self.padding_idx}")


class EmbeddingNF4(Embedding4bit):
    """:class:`Embedding4bit` with NF4 codes."""

    def __init__(self, num_embeddings, embedding_dim, **kwargs):
        kwargs["quant_type"] = "nf4"
        super().__init__(num_embeddings, embedding_dim, **kwargs)

    @classmethod
    def from_embedding(cls, embedding, blocksize: int = 64, device=None):
        return Embedding4bit.from_embedding.__func__(
            cls, embedding, quant_type="nf4", blocksize=blocksize,
            device=device)


class EmbeddingFP4(Embedding4bit):
    """:class:`Embedding4bit` with FP4 codes."""

    def __init__(self, num_embeddings, embedding_dim, **kwargs):
        kwargs["quant_type"] = "fp4"
        super().__init__(num_embeddings, embedding_dim, **kwargs)

    @classmethod
    def from_embedding(cls, embedding, blocksize: int = 64, device=None):
        return Embedding4bit.from_embedding.__func__(
            cls, embedding, quant_type="fp4", blocksize=blocksize,
            device=device)
