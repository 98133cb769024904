"""Mixtral's plain reference: the Mistral family's decoder
(:mod:`reference.mistral`), whose MLP is the routed top-k mixture of
experts when the configuration has ``num_local_experts``."""

from reference.mistral import (BITS, compare, forward_logits,  # noqa: F401
                               quant_kv)
