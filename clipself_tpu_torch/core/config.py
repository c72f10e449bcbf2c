"""Model configuration dataclasses and the JSON config registry.

A copy of `clipself_tpu/core/config.py`, so that the port imports nothing of
the JAX package; it reads the same registry files (`clipself_tpu/configs/`).
`tests/test_torch_ops.py` pins every registered config equal to the
original's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

_CONFIG_DIR = Path(__file__).resolve().parents[2] / "clipself_tpu" / "configs"


@dataclass(frozen=True)
class VisionConfig:
    """EVA-style vision transformer hyperparameters.

    Field semantics match the reference `CLIPVisionCfg`
    (`src/open_clip/eva_clip/model.py:36-62`).
    """

    image_size: int = 224
    layers: int = 12
    width: int = 768
    head_width: int = 64
    patch_size: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    patch_dropout: float = 0.0
    ls_init_value: Optional[float] = None
    # EVA02 architecture knobs
    rope: bool = False
    # BEiT-style decomposed relative position bias (reference
    # `use_rel_pos_bias`/`use_shared_rel_pos_bias`, `eva_vit_model.py:402,423-448`;
    # every shipped config uses RoPE instead, kept for EVA01-family parity)
    use_rel_pos_bias: bool = False
    use_shared_rel_pos_bias: bool = False
    pt_hw_seq_len: int = 16
    intp_freq: bool = False
    naiveswiglu: bool = False
    subln: bool = False
    postnorm: bool = False
    xattn: bool = False  # kept for config parity; attention impl is chosen at runtime
    fusedLN: bool = False  # LayerNorm is always XLA-fused on TPU; kept for parity
    global_average_pool: bool = False
    # CoCa-style attentional pooling inside the visual tower (reference
    # `transformer.py:380-384`: AttentionalPooler(output_dim, width) followed
    # by ln_post over output_dim and a square proj)
    attentional_pool: bool = False
    n_queries: int = 256
    attn_pooler_heads: int = 8
    output_tokens: bool = False
    quick_gelu: bool = False
    eva_model_name: Optional[str] = None
    # when set, the tower is a CLIP ModifiedResNet with these stage depths
    # (the reference keys this on `layers` being a list, model.py:143-151)
    resnet_layers: Optional[Tuple[int, ...]] = None
    # timm-trunk tower (reference `timm_model.py:29-239` + the convnext
    # config family): when timm_model_name is set the tower is our native
    # ConvNeXt (convnext_* names) with the TimmModel head/protocol
    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = ""
    timm_proj: str = "linear"
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None
    # transformers trunk grafting (the generic-arbitrary-trunk half of the
    # reference's timm adapter, `timm_model.py:29-239`): when hf_trunk_name
    # is set the tower is models/trunk_adapter.TrunkAdapter over the port's
    # transformers ViT — a model TYPE like "vit" configured by
    # hf_trunk_kwargs (stored as a JSON string so the config stays hashable;
    # config_from_dict accepts a plain dict); a hub id raises, its
    # config.json not being in the repository.
    hf_trunk_name: Optional[str] = None
    hf_trunk_kwargs: Optional[str] = None
    hf_trunk_pool: str = "cls"  # 'cls' | 'mean'
    ln_eps: float = 1e-6

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def rope_dim(self) -> int:
        # half the head dim is rotated per spatial axis
        return self.head_width // 2


@dataclass(frozen=True)
class TextConfig:
    """Text transformer hyperparameters (reference `CLIPTextCfg`,
    `src/open_clip/eva_clip/model.py:65-81`)."""

    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    ls_init_value: Optional[float] = None
    xattn: bool = False
    fusedLN: bool = False
    attn_mask: bool = True
    quick_gelu: bool = False
    ln_eps: float = 1e-5
    # HuggingFace text tower (reference `hf_model.py` + config JSONs like
    # `model_configs/roberta-ViT-B-32.json:10-14`): when hf_model_name is
    # set the text tower is models/hf_text.HFTextTower instead of the CLIP
    # text transformer, and tokenization routes to the matching HF tokenizer.
    hf_model_name: Optional[str] = None
    hf_tokenizer_name: Optional[str] = None
    hf_model_config: Optional[dict] = None  # offline AutoConfig kwargs
    pooler_type: str = "mean_pooler"
    proj: str = "linear"
    # CoCa text tower (reference `transformer.py:883-1016`): a learned CLS
    # token appended at the END of the sequence pools the caption stream
    embed_cls: bool = False
    output_tokens: bool = False
    pad_id: int = 0


@dataclass(frozen=True)
class MultimodalConfig:
    """CoCa multimodal decoder hyperparameters (reference `MultimodalCfg`,
    `src/open_clip/coca_model.py:44-50`)."""

    context_length: int = 76
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    ls_init_value: Optional[float] = None
    mlp_ratio: float = 4.0
    dim_head: int = 64
    n_queries: int = 256
    attn_pooler_heads: int = 8
    quick_gelu: bool = False
    ln_eps: float = 1e-5


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    # presence of a multimodal decoder config makes the model a CoCa
    # (reference keys this on "multimodal_cfg" in the JSON,
    # `src/open_clip/factory.py:215-230`)
    multimodal: Optional[MultimodalConfig] = None
    name: str = ""


def _filter_fields(cls, cfg: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(cfg) - names)
    if unknown:
        # silently dropping keys would build a DIFFERENT architecture than
        # the config asks for (typos, or unsupported reference knobs like
        # timm_model_name); the reference's **cfg unpack errors the same way
        raise ValueError(
            f"unknown {cls.__name__} config keys: {unknown} "
            f"(supported: {sorted(names)})"
        )
    return dict(cfg)


def config_from_dict(d: dict, name: str = "") -> CLIPConfig:
    vcfg = dict(d.get("vision_cfg", {}))
    tcfg = dict(d.get("text_cfg", {}))
    mcfg = d.get("multimodal_cfg")
    if d.get("quick_gelu"):  # reference puts this at top level in some configs
        vcfg.setdefault("quick_gelu", True)
        tcfg.setdefault("quick_gelu", True)
        if mcfg is not None:
            mcfg = dict(mcfg)
            mcfg.setdefault("quick_gelu", True)
    if isinstance(vcfg.get("layers"), (list, tuple)):
        vcfg["resnet_layers"] = tuple(vcfg["layers"])
        vcfg["layers"] = len(vcfg["resnet_layers"])
    if isinstance(vcfg.get("hf_trunk_kwargs"), dict):
        vcfg["hf_trunk_kwargs"] = json.dumps(vcfg["hf_trunk_kwargs"], sort_keys=True)
    vision = VisionConfig(**_filter_fields(VisionConfig, vcfg))
    text = TextConfig(**_filter_fields(TextConfig, tcfg))
    multimodal = (
        MultimodalConfig(**_filter_fields(MultimodalConfig, dict(mcfg)))
        if mcfg is not None
        else None
    )
    return CLIPConfig(
        embed_dim=d["embed_dim"], vision=vision, text=text,
        multimodal=multimodal, name=name,
    )


def list_models() -> list[str]:
    return sorted(p.stem for p in _CONFIG_DIR.glob("*.json"))


def get_model_config(name: str) -> CLIPConfig:
    """Load a named model config from the JSON registry."""
    path = _CONFIG_DIR / f"{name}.json"
    if not path.exists():
        raise KeyError(
            f"Unknown model config '{name}'. Available: {list_models()}"
        )
    with open(path) as f:
        d = json.load(f)
    return config_from_dict(d, name=name)
