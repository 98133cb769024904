"""The model's useful FLOPs, whatever implements them: 2 FLOP per weight
a token meets (a MoE layer's router and its routed experts only, not
every expert the port runs), the head once per emitted token (a prefill
needs the last prompt token's logits only), and attention's 4 * heads *
head_dim FLOP per (query, key) pair inside the causal window. Prompt
tokens count unpadded."""

from .k3 import pairs


def layer_weights(cfg: dict) -> int:
    """Weights one token meets in one layer."""
    h, d = cfg["hidden_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    i = cfg["intermediate_size"]
    attn = (nq + 2 * nkv) * h + h * nq
    mlp = 3 * h * i
    if cfg["num_local_experts"]:
        return (attn + cfg["num_experts_per_tok"] * mlp
                + cfg["num_local_experts"] * h)
    return attn + mlp


def decode_token(cfg: dict, keys: int) -> float:
    """One decode step of one slot whose query sees ``keys`` keys."""
    layers = cfg["num_hidden_layers"]
    attn = 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * keys
    return (2.0 * (layers * layer_weights(cfg)
                   + cfg["vocab_size"] * cfg["hidden_size"])
            + layers * attn)


def prefill(cfg: dict, n: int) -> float:
    """One request's prefill of n prompt tokens, its first token's
    logits included."""
    layers = cfg["num_hidden_layers"]
    attn = (4.0 * cfg["num_attention_heads"] * cfg["head_dim"]
            * pairs(n, cfg.get("sliding_window")))
    return (2.0 * n * layers * layer_weights(cfg)
            + 2.0 * cfg["vocab_size"] * cfg["hidden_size"] + layers * attn)
