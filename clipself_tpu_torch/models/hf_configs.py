"""The parts of `transformers`' model configs that the port reads, without
`transformers`.

The JAX package builds its HF towers from transformers' configs: the text
tower from `hf_model_name` (`clipself_tpu/models/hf_text.py:30-39`), the
trunk adapter from `hf_trunk_name` (`clipself_tpu/models/trunk_adapter.py:57-62`).
The port keeps its own copy of the defaults it reads
(`AutoConfig.for_model(model_type)` of transformers 4.57) and routes names
by the JAX package's two rules:

  - text: a transformers model TYPE (a key of `CONFIG_MAPPING`, copied in
    `MODEL_TYPES`) builds that type's default config offline, updated by
    `TextConfig.hf_model_config`; any other name is a hub checkpoint id;
  - trunk: a name with a "/" is a hub id; any other name is a model type,
    updated by `VisionConfig.hf_trunk_kwargs` (a JSON string).

A hub id needs the hub's `config.json`, which is not in the repository and
is never fetched: it raises OSError naming the file. A model type the port
has no encoder for raises NotImplementedError naming the type; a trunk name
that is no model type at all raises ValueError, as `for_model` does.

The port's encoders: `bert`, `roberta`, `xlm-roberta` (`models/hf_bert.py`),
`t5`, `mt5` (`models/hf_t5.py`, encoder only) for text; `vit`
(`models/hf_vit.py`) for the trunk. A config is a `SimpleNamespace` of the
merged fields; the T5 family derives `dense_act_fn` and `is_gated_act` from
`feed_forward_proj`, as `T5Config.__init__` does.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Callable, Optional

import torch
import torch.nn.functional as F

# the keys of transformers 4.57's `CONFIG_MAPPING`: the text route's test of
# "a model type" (`clipself_tpu/models/hf_text.py:35`)
MODEL_TYPES = frozenset("""
aimv2 aimv2_vision_model albert align altclip apertus arcee aria aria_text
audio-spectrogram-transformer autoformer aya_vision bamba bark bart beit bert
bert-generation big_bird bigbird_pegasus biogpt bit bitnet blenderbot blenderbot-small blip
blip-2 blip_2_qformer bloom blt bridgetower bros camembert canine chameleon chinese_clip
chinese_clip_vision_model clap clip clip_text_model clip_vision_model clipseg clvp
code_llama codegen cohere cohere2 cohere2_vision colpali colqwen2 conditional_detr convbert
convnext convnextv2 cpmant csm ctrl cvt d_fine dab-detr dac data2vec-audio data2vec-text
data2vec-vision dbrx deberta deberta-v2 decision_transformer deepseek_v2 deepseek_v3
deepseek_vl deepseek_vl_hybrid deformable_detr deit depth_anything depth_pro deta detr dia
diffllama dinat dinov2 dinov2_with_registers dinov3_convnext dinov3_vit distilbert doge
donut-swin dots1 dpr dpt edgetam edgetam_video edgetam_vision_model efficientformer
efficientloftr efficientnet electra emu3 encodec encoder-decoder eomt ernie ernie4_5
ernie4_5_moe ernie_m esm evolla exaone4 falcon falcon_h1 falcon_mamba fastspeech2_conformer
fastspeech2_conformer_with_hifigan flaubert flava flex_olmo florence2 fnet focalnet fsmt
funnel fuyu gemma gemma2 gemma3 gemma3_text gemma3n gemma3n_audio gemma3n_text
gemma3n_vision git glm glm4 glm4_moe glm4v glm4v_moe glm4v_moe_text glm4v_text glpn got_ocr2
gpt-sw3 gpt2 gpt_bigcode gpt_neo gpt_neox gpt_neox_japanese gpt_oss gptj gptsan-japanese
granite granite_speech granitemoe granitemoehybrid granitemoeshared granitevision graphormer
grounding-dino groupvit helium hgnet_v2 hiera hubert hunyuan_v1_dense hunyuan_v1_moe ibert
idefics idefics2 idefics3 idefics3_vision ijepa imagegpt informer instructblip
instructblipvideo internvl internvl_vision jamba janus jetmoe jukebox kosmos-2 kosmos-2.5
kyutai_speech_to_text layoutlm layoutlmv2 layoutlmv3 led levit lfm2 lfm2_vl lightglue lilt
llama llama4 llama4_text llava llava_next llava_next_video llava_onevision longcat_flash
longformer longt5 luke lxmert m2m_100 mamba mamba2 marian markuplm mask2former maskformer
maskformer-swin mbart mctct mega megatron-bert metaclip_2 mgp-str mimi minimax ministral
mistral mistral3 mixtral mlcd mllama mm-grounding-dino mobilebert mobilenet_v1 mobilenet_v2
mobilevit mobilevitv2 modernbert modernbert-decoder moonshine moshi mpnet mpt mra mt5
musicgen musicgen_melody mvp nat nemotron nezha nllb-moe nougat nystromformer olmo olmo2
olmo3 olmoe omdet-turbo oneformer open-llama openai-gpt opt ovis2 owlv2 owlvit paligemma
parakeet_ctc parakeet_encoder patchtsmixer patchtst pegasus pegasus_x perceiver
perception_encoder perception_lm persimmon phi phi3 phi4_multimodal phimoe pix2struct
pixtral plbart poolformer pop2piano prompt_depth_anything prophetnet pvt pvt_v2 qdqbert
qwen2 qwen2_5_omni qwen2_5_vl qwen2_5_vl_text qwen2_audio qwen2_audio_encoder qwen2_moe
qwen2_vl qwen2_vl_text qwen3 qwen3_moe qwen3_next qwen3_omni_moe qwen3_vl qwen3_vl_moe
qwen3_vl_moe_text qwen3_vl_text rag realm recurrent_gemma reformer regnet rembert resnet
retribert roberta roberta-prelayernorm roc_bert roformer rt_detr rt_detr_resnet rt_detr_v2
rwkv sam sam2 sam2_hiera_det_model sam2_video sam2_vision_model sam_hq sam_hq_vision_model
sam_vision_model seamless_m4t seamless_m4t_v2 seed_oss segformer seggpt sew sew-d
shieldgemma2 siglip siglip2 siglip2_vision_model siglip_vision_model smollm3 smolvlm
smolvlm_vision speech-encoder-decoder speech_to_text speech_to_text_2 speecht5 splinter
squeezebert stablelm starcoder2 superglue superpoint swiftformer swin swin2sr swinv2
switch_transformers t5 t5gemma table-transformer tapas textnet time_series_transformer
timesfm timesformer timm_backbone timm_wrapper trajectory_transformer transfo-xl trocr tvlt
tvp udop umt5 unispeech unispeech-sat univnet upernet van vaultgemma video_llava videomae
vilt vipllava vision-encoder-decoder vision-text-dual-encoder visual_bert vit vit_hybrid
vit_mae vit_msn vitdet vitmatte vitpose vitpose_backbone vits vivit vjepa2 voxtral
voxtral_encoder wav2vec2 wav2vec2-bert wav2vec2-conformer wavlm whisper xclip xcodec xglm
xlm xlm-prophetnet xlm-roberta xlm-roberta-xl xlnet xlstm xmod yolos yoso zamba zamba2
zoedepth
""".split())

_BERT = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, hidden_act="gelu", max_position_embeddings=512, type_vocab_size=2,
    layer_norm_eps=1e-12, pad_token_id=0, position_embedding_type="absolute",
    initializer_range=0.02, is_encoder_decoder=False,
)
_T5 = dict(
    vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_heads=8,
    relative_attention_num_buckets=32, relative_attention_max_distance=128,
    layer_norm_epsilon=1e-6, feed_forward_proj="relu", pad_token_id=0, initializer_factor=1.0,
    is_encoder_decoder=True,
)
# model type -> its `for_model` defaults, for the fields the port reads
DEFAULTS: dict[str, dict] = {
    "bert": _BERT,
    "roberta": {**_BERT, "vocab_size": 50265, "pad_token_id": 1},
    "xlm-roberta": {**_BERT, "pad_token_id": 1},
    "t5": _T5,
    "mt5": {**_T5, "vocab_size": 250112, "d_ff": 1024, "num_layers": 8, "num_heads": 6,
            "feed_forward_proj": "gated-gelu"},
    "vit": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
        hidden_act="gelu", layer_norm_eps=1e-12, image_size=224, patch_size=16, num_channels=3,
        qkv_bias=True, initializer_range=0.02, is_encoder_decoder=False,
    ),
}
TEXT_TYPES = ("bert", "roberta", "xlm-roberta", "t5", "mt5")
TRUNK_TYPES = ("vit",)
# the model types whose positions start after the pad id and skip padding
# (`clipself_tpu/models/hf_text.py:130`)
PAD_OFFSET_POSITIONS = ("roberta", "roberta-prelayernorm", "xlm-roberta")


def _hub(name: str, what: str) -> OSError:
    return OSError(
        f"{what} {name!r} is a hub checkpoint id: its config.json is not in the repository and "
        "nothing is fetched; name a model type "
        f"({', '.join(TEXT_TYPES if what == 'HF text tower' else TRUNK_TYPES)}) to build its "
        "default config offline"
    )


def _build(model_type: str, kwargs: Optional[dict]) -> SimpleNamespace:
    fields = {**DEFAULTS[model_type], **(kwargs or {}), "model_type": model_type}
    if model_type in ("t5", "mt5"):
        act = fields["feed_forward_proj"].split("-")
        if len(act) > 2 or (len(act) > 1 and act[0] != "gated"):
            raise ValueError(f"feed_forward_proj {fields['feed_forward_proj']!r} is not `gated-{{act}}` or `{{act}}`")
        fields["is_gated_act"] = act[0] == "gated"
        fields["dense_act_fn"] = "gelu_new" if fields["feed_forward_proj"] == "gated-gelu" else act[-1]
        activation(fields["dense_act_fn"])
    else:
        activation(fields["hidden_act"])
    if fields.get("position_embedding_type", "absolute") != "absolute":
        raise NotImplementedError(
            f"{model_type}: position_embedding_type {fields['position_embedding_type']!r} (the port's "
            "encoders take absolute positions)"
        )
    return SimpleNamespace(**fields)


def text_config(name: str, kwargs: Optional[dict] = None) -> SimpleNamespace:
    """The config of an HF text tower named ``name`` (`TextConfig.hf_model_name`)
    updated by ``kwargs`` (`TextConfig.hf_model_config`)."""
    if name not in MODEL_TYPES:
        raise _hub(name, "HF text tower")
    if name not in TEXT_TYPES:
        raise NotImplementedError(
            f"HF text tower model type {name!r}: the port has encoders for {', '.join(TEXT_TYPES)}"
        )
    return _build(name, kwargs)


def trunk_config(name: str, kwargs_json: Optional[str] = None) -> SimpleNamespace:
    """The config of a transformers vision trunk named ``name``
    (`VisionConfig.hf_trunk_name`) updated by ``kwargs_json``
    (`VisionConfig.hf_trunk_kwargs`)."""
    if "/" in name:
        raise _hub(name, "HF vision trunk")
    if name not in MODEL_TYPES:
        raise ValueError(f"HF vision trunk {name!r} is no transformers model type")
    if name not in TRUNK_TYPES:
        raise NotImplementedError(
            f"HF vision trunk model type {name!r}: the port has a trunk for {', '.join(TRUNK_TYPES)}"
        )
    return _build(name, json.loads(kwargs_json or "{}"))


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# transformers' Flax `ACT2FN` (`modeling_flax_utils.py:73-82`), what the JAX
# towers run: "gelu" is exact (erf), "gelu_new" and "gelu_pytorch_tanh" the
# tanh form
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": F.gelu, "relu": F.relu, "silu": F.silu, "swish": F.silu, "gelu_new": _tanh_gelu,
    "quick_gelu": _quick_gelu, "gelu_pytorch_tanh": _tanh_gelu, "tanh": torch.tanh,
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} (the port takes {sorted(ACTIVATIONS)})")
    return ACTIVATIONS[name]
