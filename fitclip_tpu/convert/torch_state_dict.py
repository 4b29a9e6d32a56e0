"""PyTorch checkpoint -> JAX pytree conversion for the CLIP encoder family.

The reference framework's released artifacts are torch `.pt` state dicts
(README.md:35-54); loading them must hold the embeddings to <=1e-3.
This module maps both naming schemas onto the Flax parameter tree of
``fitclip_tpu.models.clip.CLIPModel``:

- "openai": the `clip` package layout (visual.conv1.weight,
  transformer.resblocks.N.attn.in_proj_weight, ...)
- "hf": HuggingFace ``CLIPModel`` layout (vision_model.encoder.layers.N.
  self_attn.q_proj.weight, ...)

torch is used only here (host-side, CPU) to deserialize; nothing on the
compute path imports it.
"""

from typing import Dict, Mapping, Optional

import numpy as np

from fitclip_tpu.models.clip.model import CLIPConfig


def load_torch_state_dict(path: str, strip_prefix: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint into numpy arrays.

    Handles plain state dicts, Lightning-style checkpoints ({"state_dict": ...};
    reference util/checkpoint_utils.py:9-12), and JIT archives. ``strip_prefix``
    keeps only keys under that prefix and removes it (e.g. "encoder.model.").
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):  # e.g. a scripted/eager module
        obj = obj.state_dict()
    out = {}
    for key, value in obj.items():
        if strip_prefix:
            if not key.startswith(strip_prefix):
                continue
            key = key[len(strip_prefix):]
        if hasattr(value, "detach"):
            out[key] = value.detach().to(torch.float32).cpu().numpy()
    return out


def detect_schema(state_dict: Mapping[str, np.ndarray]) -> str:
    if any(k.startswith("vision_model.") for k in state_dict):
        return "hf"
    if any(k.startswith("visual.") for k in state_dict):
        return "openai"
    raise ValueError("Unrecognized CLIP state-dict schema; expected 'visual.*' or 'vision_model.*' keys")


def config_from_openai_state_dict(state_dict: Mapping[str, np.ndarray]) -> CLIPConfig:
    """Infer the CLIPConfig from an OpenAI-layout state dict (same tensor-shape
    arithmetic the `clip` package does in build_model)."""
    from fitclip_tpu.models.clip.model import TextConfig, VisionConfig

    if "visual.conv1.weight" not in state_dict:
        raise ValueError("Only ViT CLIP variants are supported by config inference for now")
    conv1 = state_dict["visual.conv1.weight"]  # (width, 3, p, p)
    width, _, patch = conv1.shape[0], conv1.shape[1], conv1.shape[2]
    grid = int(round((state_dict["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = len({k.split(".")[3] for k in state_dict
                         if k.startswith("visual.transformer.resblocks.")})
    embed_dim = state_dict["text_projection"].shape[1]
    text_width = state_dict["ln_final.weight"].shape[0]
    context_length = state_dict["positional_embedding"].shape[0]
    vocab_size = state_dict["token_embedding.weight"].shape[0]
    text_layers = len({k.split(".")[2] for k in state_dict
                       if k.startswith("transformer.resblocks.")})
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(image_size=grid * patch, patch_size=patch, width=width,
                            layers=vision_layers, heads=width // 64),
        text=TextConfig(context_length=context_length, vocab_size=vocab_size,
                        width=text_width, layers=text_layers, heads=text_width // 64),
    )


def _patch_kernel(conv_weight: np.ndarray) -> np.ndarray:
    # torch conv (out, in=3, ph, pw) -> matmul kernel rows ordered (ph, pw, c).
    return conv_weight.transpose(2, 3, 1, 0).reshape(-1, conv_weight.shape[0])


def _ln(sd, prefix):
    return {"ln": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}


def _stack(arrays):
    return np.stack(arrays, axis=0)


def _openai_tower_blocks(sd: Mapping[str, np.ndarray], prefix: str, layers: int) -> dict:
    """Stack per-layer resblock weights into the scan layout (leading L axis)."""
    def per_layer(fmt):
        return [sd[fmt.format(prefix=prefix, i=i)] for i in range(layers)]

    return {
        "attn": {
            "in_proj": {
                "kernel": _stack([w.T for w in per_layer("{prefix}.resblocks.{i}.attn.in_proj_weight")]),
                "bias": _stack(per_layer("{prefix}.resblocks.{i}.attn.in_proj_bias")),
            },
            "out_proj": {
                "kernel": _stack([w.T for w in per_layer("{prefix}.resblocks.{i}.attn.out_proj.weight")]),
                "bias": _stack(per_layer("{prefix}.resblocks.{i}.attn.out_proj.bias")),
            },
        },
        "ln_1": {"ln": {"scale": _stack(per_layer("{prefix}.resblocks.{i}.ln_1.weight")),
                        "bias": _stack(per_layer("{prefix}.resblocks.{i}.ln_1.bias"))}},
        "ln_2": {"ln": {"scale": _stack(per_layer("{prefix}.resblocks.{i}.ln_2.weight")),
                        "bias": _stack(per_layer("{prefix}.resblocks.{i}.ln_2.bias"))}},
        "mlp_fc": {"kernel": _stack([w.T for w in per_layer("{prefix}.resblocks.{i}.mlp.c_fc.weight")]),
                   "bias": _stack(per_layer("{prefix}.resblocks.{i}.mlp.c_fc.bias"))},
        "mlp_proj": {"kernel": _stack([w.T for w in per_layer("{prefix}.resblocks.{i}.mlp.c_proj.weight")]),
                     "bias": _stack(per_layer("{prefix}.resblocks.{i}.mlp.c_proj.bias"))},
    }


def _hf_tower_blocks(sd: Mapping[str, np.ndarray], prefix: str, layers: int) -> dict:
    def get(fmt, i):
        return sd[fmt.format(prefix=prefix, i=i)]

    in_proj_w, in_proj_b, out_w, out_b = [], [], [], []
    ln1_s, ln1_b, ln2_s, ln2_b = [], [], [], []
    fc_w, fc_b, proj_w, proj_b = [], [], [], []
    for i in range(layers):
        q = get("{prefix}.layers.{i}.self_attn.q_proj.weight", i)
        k = get("{prefix}.layers.{i}.self_attn.k_proj.weight", i)
        v = get("{prefix}.layers.{i}.self_attn.v_proj.weight", i)
        in_proj_w.append(np.concatenate([q, k, v], axis=0).T)
        in_proj_b.append(np.concatenate([
            get("{prefix}.layers.{i}.self_attn.q_proj.bias", i),
            get("{prefix}.layers.{i}.self_attn.k_proj.bias", i),
            get("{prefix}.layers.{i}.self_attn.v_proj.bias", i)]))
        out_w.append(get("{prefix}.layers.{i}.self_attn.out_proj.weight", i).T)
        out_b.append(get("{prefix}.layers.{i}.self_attn.out_proj.bias", i))
        ln1_s.append(get("{prefix}.layers.{i}.layer_norm1.weight", i))
        ln1_b.append(get("{prefix}.layers.{i}.layer_norm1.bias", i))
        ln2_s.append(get("{prefix}.layers.{i}.layer_norm2.weight", i))
        ln2_b.append(get("{prefix}.layers.{i}.layer_norm2.bias", i))
        fc_w.append(get("{prefix}.layers.{i}.mlp.fc1.weight", i).T)
        fc_b.append(get("{prefix}.layers.{i}.mlp.fc1.bias", i))
        proj_w.append(get("{prefix}.layers.{i}.mlp.fc2.weight", i).T)
        proj_b.append(get("{prefix}.layers.{i}.mlp.fc2.bias", i))
    return {
        "attn": {"in_proj": {"kernel": _stack(in_proj_w), "bias": _stack(in_proj_b)},
                 "out_proj": {"kernel": _stack(out_w), "bias": _stack(out_b)}},
        "ln_1": {"ln": {"scale": _stack(ln1_s), "bias": _stack(ln1_b)}},
        "ln_2": {"ln": {"scale": _stack(ln2_s), "bias": _stack(ln2_b)}},
        "mlp_fc": {"kernel": _stack(fc_w), "bias": _stack(fc_b)},
        "mlp_proj": {"kernel": _stack(proj_w), "bias": _stack(proj_b)},
    }


def clip_params_from_torch(state_dict: Mapping[str, np.ndarray],
                           config: CLIPConfig) -> dict:
    """Build the Flax parameter pytree for CLIPModel from a torch state dict."""
    schema = detect_schema(state_dict)
    sd = dict(state_dict)
    width = config.vision.width

    if schema == "openai":
        visual = {
            "patch_embed": {
                "kernel": _patch_kernel(sd["visual.conv1.weight"]),
                # OpenAI's conv1 has no bias; keep zeros so pixel-normalization
                # folding has a bias slot to write into.
                "bias": sd.get("visual.conv1.bias", np.zeros(width, np.float32)),
            },
            "class_embedding": sd["visual.class_embedding"],
            "positional_embedding": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "transformer": {"blocks": _openai_tower_blocks(sd, "visual.transformer",
                                                           config.vision.layers)},
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        }
        text = {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "transformer": {"blocks": _openai_tower_blocks(sd, "transformer",
                                                           config.text.layers)},
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": sd["text_projection"],
        }
    else:  # hf
        # HF historically misspells pre_layrnorm; accept both.
        pre_ln = "vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd \
            else "vision_model.pre_layernorm"
        visual = {
            "patch_embed": {
                "kernel": _patch_kernel(sd["vision_model.embeddings.patch_embedding.weight"]),
                "bias": sd.get("vision_model.embeddings.patch_embedding.bias",
                               np.zeros(width, np.float32)),
            },
            "class_embedding": sd["vision_model.embeddings.class_embedding"].reshape(-1),
            "positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
            "ln_pre": _ln(sd, pre_ln),
            "transformer": {"blocks": _hf_tower_blocks(sd, "vision_model.encoder",
                                                       config.vision.layers)},
            "ln_post": _ln(sd, "vision_model.post_layernorm"),
            "proj": sd["visual_projection.weight"].T,
        }
        text = {
            "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
            "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
            "transformer": {"blocks": _hf_tower_blocks(sd, "text_model.encoder",
                                                       config.text.layers)},
            "ln_final": _ln(sd, "text_model.final_layer_norm"),
            "text_projection": sd["text_projection.weight"].T,
        }

    params = {"visual": visual, "text": text}
    return jax_tree_cast(params)


def jax_tree_cast(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)
