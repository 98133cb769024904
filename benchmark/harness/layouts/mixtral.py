"""Mixtral: the Mistral family's layout with a router and experts in each
layer's MLP (:mod:`harness.weights` draws them when the configuration
has ``num_local_experts``)."""

from .mistral import build_engine, make_weights, read_kv  # noqa: F401
