from .engine import DecodeEngine, decode_chunk, decode_step, prefill_batch, prefill_step
from .kvcache import KVCache
from .sampler import SamplingArrays, SamplingParams

__all__ = ["DecodeEngine", "decode_chunk", "decode_step", "prefill_batch",
           "prefill_step", "KVCache", "SamplingArrays", "SamplingParams"]
