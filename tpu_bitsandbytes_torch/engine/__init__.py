"""Decode engine: quantized KV cache, samplers, continuous batching."""

from .engine import (DecodeEngine, Request, decode_chunk, decode_step,
                     prefill_batch, prefill_step)
from .kvcache import KVCache
from .sampler import SamplingArrays, SamplingParams, sample
from .speculative import propose_ngram, verify_step

__all__ = ["DecodeEngine", "decode_chunk", "decode_step", "prefill_batch",
           "prefill_step", "KVCache", "SamplingArrays", "SamplingParams",
           "sample", "Request", "propose_ngram", "verify_step"]
