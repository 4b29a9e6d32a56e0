"""DistilBERT encoder in Flax (the Frozen-in-Time text tower).

transformers no longer ships Flax models, so this is a from-scratch
implementation of the DistilBERT forward pass (word+position embeddings with
LN eps 1e-12, 6 post-LN blocks with separate q/k/v/out projections and
GELU FFN), parameter tree mirroring HF torch naming for mechanical conversion.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp

from fitclip_tpu.ops.attention import attention

PRECISION = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    hidden_dim: int = 3072
    n_layers: int = 6
    n_heads: int = 12
    max_position_embeddings: int = 512

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "DistilBertConfig":
        return DistilBertConfig(vocab_size=vocab_size, dim=32, hidden_dim=64,
                                n_layers=2, n_heads=4, max_position_embeddings=32)


class _LayerNorm(nn.Module):
    eps: float = 1e-12

    @nn.compact
    def __call__(self, x):
        dim = x.shape[-1]
        weight = self.param("weight", nn.initializers.ones, (dim,))
        bias = self.param("bias", nn.initializers.zeros, (dim,))
        xf = x.astype(jnp.float32)
        normed = (xf - xf.mean(-1, keepdims=True)) * jax.lax.rsqrt(
            xf.var(-1, keepdims=True) + self.eps)
        return (normed * weight + bias).astype(x.dtype)


class TransformerBlock(nn.Module):
    config: DistilBertConfig
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, attention_mask):
        cfg = self.config
        head_dim = cfg.dim // cfg.n_heads

        def dense(features, name):
            return nn.Dense(features, name=name, precision=PRECISION,
                            dtype=self.dtype)

        def heads(t):
            return t.reshape(*t.shape[:-1], cfg.n_heads, head_dim)

        q = heads(dense(cfg.dim, "attention_q_lin")(x))
        k = heads(dense(cfg.dim, "attention_k_lin")(x))
        v = heads(dense(cfg.dim, "attention_v_lin")(x))
        attn = attention(q, k, v, key_mask=attention_mask > 0).reshape(*x.shape)
        attn = dense(cfg.dim, "attention_out_lin")(attn)
        x = _LayerNorm(name="sa_layer_norm")(x + attn)

        h = dense(cfg.hidden_dim, "ffn_lin1")(x)
        h = nn.gelu(h, approximate=False)
        h = dense(cfg.dim, "ffn_lin2")(h)
        return _LayerNorm(name="output_layer_norm")(x + h)


class DistilBertModel(nn.Module):
    config: DistilBertConfig
    # fp32 (default) = torch-oracle parity; bf16 = throughput eval
    # (LayerNorms/softmax stay fp32 either way).
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, input_ids: jnp.ndarray,
                 attention_mask: jnp.ndarray) -> jnp.ndarray:
        cfg = self.config
        word = self.param("word_embeddings", nn.initializers.normal(0.02),
                          (cfg.vocab_size, cfg.dim))
        position = self.param("position_embeddings", nn.initializers.normal(0.02),
                              (cfg.max_position_embeddings, cfg.dim))
        x = word[input_ids] + position[: input_ids.shape[1]]
        x = _LayerNorm(name="embeddings_layer_norm")(x).astype(self.dtype)
        for i in range(cfg.n_layers):
            x = TransformerBlock(cfg, dtype=self.dtype,
                                 name=f"layer_{i}")(x, attention_mask)
        return x  # last_hidden_state


def distilbert_params_from_torch(state_dict, config: DistilBertConfig) -> dict:
    """HF DistilBertModel torch state dict -> this module's param tree."""
    import numpy as np

    sd = {k.replace("distilbert.", ""): np.asarray(v, np.float32)
          for k, v in state_dict.items()}
    params = {
        "word_embeddings": sd["embeddings.word_embeddings.weight"],
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "embeddings_layer_norm": {"weight": sd["embeddings.LayerNorm.weight"],
                                  "bias": sd["embeddings.LayerNorm.bias"]},
    }
    for i in range(config.n_layers):
        prefix = f"transformer.layer.{i}"
        params[f"layer_{i}"] = {
            "attention_q_lin": {"kernel": sd[f"{prefix}.attention.q_lin.weight"].T,
                                "bias": sd[f"{prefix}.attention.q_lin.bias"]},
            "attention_k_lin": {"kernel": sd[f"{prefix}.attention.k_lin.weight"].T,
                                "bias": sd[f"{prefix}.attention.k_lin.bias"]},
            "attention_v_lin": {"kernel": sd[f"{prefix}.attention.v_lin.weight"].T,
                                "bias": sd[f"{prefix}.attention.v_lin.bias"]},
            "attention_out_lin": {"kernel": sd[f"{prefix}.attention.out_lin.weight"].T,
                                  "bias": sd[f"{prefix}.attention.out_lin.bias"]},
            "sa_layer_norm": {"weight": sd[f"{prefix}.sa_layer_norm.weight"],
                              "bias": sd[f"{prefix}.sa_layer_norm.bias"]},
            "ffn_lin1": {"kernel": sd[f"{prefix}.ffn.lin1.weight"].T,
                         "bias": sd[f"{prefix}.ffn.lin1.bias"]},
            "ffn_lin2": {"kernel": sd[f"{prefix}.ffn.lin2.weight"].T,
                         "bias": sd[f"{prefix}.ffn.lin2.bias"]},
            "output_layer_norm": {"weight": sd[f"{prefix}.output_layer_norm.weight"],
                                  "bias": sd[f"{prefix}.output_layer_norm.bias"]},
        }
    return params
