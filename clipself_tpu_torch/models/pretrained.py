"""The pretrained-weight catalog and its resolution to a local file.

A copy of `clipself_tpu/models/pretrained.py` (reference registries
`src/open_clip/pretrained.py:21-376`, `src/open_clip/eva_clip/pretrained.py`):
`PRETRAINED` maps (model name, tag) to a weight source (a direct URL or a
Hugging Face hub repo), with the quickgelu aliases; `tests/test_torch_openai_pretrained.py`
pins it equal to the original. `resolve_pretrained` takes a local path as it
is, and a catalog tag to its file in the cache directory
(`default_cache_dir`: `$CLIPSELF_CACHE`, else `~/.cache/clipself_tpu`),
where the JAX package's `download_pretrained` puts it. The port fetches
nothing: a known tag whose file is not in the cache raises and names its
source (the fetch is ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def _cfg(url: str = "", hf_hub: str = "", filename: str = "",
         mean=None, std=None) -> dict:
    return {"url": url, "hf_hub": hf_hub, "filename": filename,
            "mean": mean, "std": std}


_OPENAI_ROOT = "https://openaipublic.azureedge.net/clip/models"
_OC_ROOT = "https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights"
_INCEPTION = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


def _eva(filename: str) -> dict:
    return _cfg(hf_hub="QuanSun/EVA-CLIP", filename=filename)


def _openai(sha: str, name: str) -> dict:
    return _cfg(url=f"{_OPENAI_ROOT}/{sha}/{name}")


# (model name, tag) -> weight source. Tag set mirrors the reference catalogs
# (`src/open_clip/pretrained.py:30-246` + `eva_clip/pretrained.py:30-140`);
# only architectures this framework builds are listed — which is all of them
# except the three timm ViT/swin registry stubs.
PRETRAINED = {
    "EVA02-CLIP-B-16": {
        "eva": _eva("EVA02_B_psz14to16.pt"),
        "eva02": _eva("EVA02_B_psz14to16.pt"),
        "eva_clip": _eva("EVA02_CLIP_B_psz16_s8B.pt"),
        "eva02_clip": _eva("EVA02_CLIP_B_psz16_s8B.pt"),
    },
    "EVA02-CLIP-L-14-336": {
        "eva_clip": _eva("EVA02_CLIP_L_336_psz14_s6B.pt"),
        "eva02_clip": _eva("EVA02_CLIP_L_336_psz14_s6B.pt"),
        "eva_clip_224to336": _eva("EVA02_CLIP_L_psz14_224to336.pt"),
        "eva02_clip_224to336": _eva("EVA02_CLIP_L_psz14_224to336.pt"),
        # convenience alias used by the shipped scripts
        "eva": _eva("EVA02_CLIP_L_336_psz14_s6B.pt"),
    },
    "EVA02-CLIP-L-14": {
        "eva": _eva("EVA02_L_psz14.pt"),
        "eva02": _eva("EVA02_L_psz14.pt"),
        "eva_clip": _eva("EVA02_CLIP_L_psz14_s4B.pt"),
        "eva02_clip": _eva("EVA02_CLIP_L_psz14_s4B.pt"),
    },
    "EVA01-CLIP-g-14": {
        "eva": _eva("EVA01_g_psz14.pt"),
        "eva01": _eva("EVA01_g_psz14.pt"),
        "eva_clip": _eva("EVA01_CLIP_g_14_psz14_s11B.pt"),
        "eva01_clip": _eva("EVA01_CLIP_g_14_psz14_s11B.pt"),
    },
    "EVA01-CLIP-g-14-plus": {
        "eva": _eva("EVA01_g_psz14.pt"),
        "eva01": _eva("EVA01_g_psz14.pt"),
        "eva_clip": _eva("EVA01_CLIP_g_14_plus_psz14_s11B.pt"),
        "eva01_clip": _eva("EVA01_CLIP_g_14_plus_psz14_s11B.pt"),
    },
    "EVA02-CLIP-bigE-14": {
        "eva": _eva("EVA02_E_psz14.pt"),
        "eva02": _eva("EVA02_E_psz14.pt"),
        "eva_clip": _eva("EVA02_CLIP_E_psz14_s4B.pt"),
        "eva02_clip": _eva("EVA02_CLIP_E_psz14_s4B.pt"),
    },
    "EVA02-CLIP-bigE-14-plus": {
        "eva": _eva("EVA02_E_psz14.pt"),
        "eva02": _eva("EVA02_E_psz14.pt"),
        "eva_clip": _eva("EVA02_CLIP_E_psz14_plus_s9B.pt"),
        "eva02_clip": _eva("EVA02_CLIP_E_psz14_plus_s9B.pt"),
    },
    "RN50": {
        "openai": _openai("afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762", "RN50.pt"),
        "yfcc15m": _cfg(url=f"{_OC_ROOT}/rn50-quickgelu-yfcc15m-455df137.pt"),
        "cc12m": _cfg(url=f"{_OC_ROOT}/rn50-quickgelu-cc12m-f000538c.pt"),
    },
    "RN101": {
        "openai": _openai("8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599", "RN101.pt"),
        "yfcc15m": _cfg(url=f"{_OC_ROOT}/rn101-quickgelu-yfcc15m-3e04b30e.pt"),
    },
    "RN50x4": {
        "openai": _openai("7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd", "RN50x4.pt"),
    },
    "RN50x16": {
        "openai": _openai("52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa", "RN50x16.pt"),
    },
    "RN50x64": {
        "openai": _openai("be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c", "RN50x64.pt"),
    },
    "ViT-B-32": {
        "openai": _openai("40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af", "ViT-B-32.pt"),
        "laion400m_e31": _cfg(url=f"{_OC_ROOT}/vit_b_32-quickgelu-laion400m_e31-d867053b.pt"),
        "laion400m_e32": _cfg(url=f"{_OC_ROOT}/vit_b_32-quickgelu-laion400m_e32-46683a32.pt"),
        "laion2b_e16": _cfg(url=f"{_OC_ROOT}/vit_b_32-laion2b_e16-af8dbd0c.pth"),
        "laion2b_s34b_b79k": _cfg(hf_hub="laion/CLIP-ViT-B-32-laion2B-s34B-b79K"),
    },
    "ViT-B-16": {
        "openai": _openai("5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f", "ViT-B-16.pt"),
        "laion400m_e31": _cfg(url=f"{_OC_ROOT}/vit_b_16-laion400m_e31-00efa78f.pt"),
        "laion400m_e32": _cfg(url=f"{_OC_ROOT}/vit_b_16-laion400m_e32-55e67d44.pt"),
        "laion2b_s34b_b88k": _cfg(hf_hub="laion/CLIP-ViT-B-16-laion2B-s34B-b88K"),
    },
    "ViT-B-16-plus-240": {
        "laion400m_e31": _cfg(url=f"{_OC_ROOT}/vit_b_16_plus_240-laion400m_e31-8fb26589.pt"),
        "laion400m_e32": _cfg(url=f"{_OC_ROOT}/vit_b_16_plus_240-laion400m_e32-699c4b84.pt"),
    },
    "ViT-L-14": {
        "openai": _openai("b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836", "ViT-L-14.pt"),
        "laion400m_e31": _cfg(url=f"{_OC_ROOT}/vit_l_14-laion400m_e31-69988bb6.pt"),
        "laion400m_e32": _cfg(url=f"{_OC_ROOT}/vit_l_14-laion400m_e32-3d133497.pt"),
        "laion2b_s32b_b82k": _cfg(
            hf_hub="laion/CLIP-ViT-L-14-laion2B-s32B-b82K",
            mean=_INCEPTION[0], std=_INCEPTION[1],
        ),
    },
    "ViT-L-14-336": {
        "openai": _openai("3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02", "ViT-L-14-336px.pt"),
    },
    "ViT-H-14": {
        "laion2b_s32b_b79k": _cfg(hf_hub="laion/CLIP-ViT-H-14-laion2B-s32B-b79K"),
    },
    "ViT-g-14": {
        "laion2b_s12b_b42k": _cfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s12B-b42K"),
        "laion2b_s34b_b88k": _cfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s34B-b88K"),
    },
    "ViT-bigG-14": {
        "laion2b_s39b_b160k": _cfg(hf_hub="laion/CLIP-ViT-bigG-14-laion2B-39B-b160k"),
    },
    "roberta-ViT-B-32": {
        "laion2b_s12b_b32k": _cfg(hf_hub="laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k"),
    },
    "xlm-roberta-base-ViT-B-32": {
        "laion5b_s13b_b90k": _cfg(hf_hub="laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k"),
    },
    "xlm-roberta-large-ViT-H-14": {
        "frozen_laion5b_s13b_b90k": _cfg(hf_hub="laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k"),
    },
    "convnext_base": {
        "laion400m_s13b_b51k": _cfg(hf_hub="laion/CLIP-convnext_base-laion400M-s13B-b51K"),
    },
    "convnext_base_w": {
        "laion2b_s13b_b82k": _cfg(hf_hub="laion/CLIP-convnext_base_w-laion2B-s13B-b82K"),
        "laion2b_s13b_b82k_augreg": _cfg(hf_hub="laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg"),
        "laion_aesthetic_s13b_b82k": _cfg(hf_hub="laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K"),
    },
    "convnext_base_w_320": {
        "laion_aesthetic_s13b_b82k": _cfg(hf_hub="laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K"),
        "laion_aesthetic_s13b_b82k_augreg": _cfg(hf_hub="laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-augreg"),
    },
    "convnext_large_d": {
        "laion2b_s26b_b102k_augreg": _cfg(hf_hub="laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg"),
    },
    "convnext_large_d_320": {
        "laion2b_s29b_b131k_ft": _cfg(hf_hub="laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft"),
        "laion2b_s29b_b131k_ft_soup": _cfg(hf_hub="laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup"),
    },
    "convnext_xxlarge": {
        "laion2b_s34b_b82k_augreg": _cfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg"),
        "laion2b_s34b_b82k_augreg_rewind": _cfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind"),
        "laion2b_s34b_b82k_augreg_soup": _cfg(hf_hub="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup"),
    },
    "coca_ViT-B-32": {
        "laion2b_s13b_b90k": _cfg(hf_hub="laion/CoCa-ViT-B-32-laion2B-s13B-b90k"),
        "mscoco_finetuned_laion2b_s13b_b90k": _cfg(hf_hub="laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k"),
    },
    "coca_ViT-L-14": {
        "laion2b_s13b_b90k": _cfg(hf_hub="laion/CoCa-ViT-L-14-laion2B-s13B-b90k"),
        "mscoco_finetuned_laion2b_s13b_b90k": _cfg(hf_hub="laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k"),
    },
}

# quickgelu architecture variants share their base model's weight sources
# (reference `pretrained.py:39-46,90-97`)
PRETRAINED["RN50-quickgelu"] = {
    t: PRETRAINED["RN50"][t] for t in ("openai", "yfcc15m", "cc12m")
}
PRETRAINED["RN101-quickgelu"] = {
    t: PRETRAINED["RN101"][t] for t in ("openai", "yfcc15m")
}
PRETRAINED["ViT-B-32-quickgelu"] = {
    t: PRETRAINED["ViT-B-32"][t] for t in ("openai", "laion400m_e31", "laion400m_e32")
}
PRETRAINED["ViT-B-16-quickgelu"] = {"openai": PRETRAINED["ViT-B-16"]["openai"]}
PRETRAINED["ViT-L-14-quickgelu"] = {"openai": PRETRAINED["ViT-L-14"]["openai"]}


def list_pretrained() -> list[tuple[str, str]]:
    return [(m, t) for m, tags in PRETRAINED.items() for t in tags]


def list_pretrained_tags_by_model(model: str) -> list[str]:
    return list(PRETRAINED.get(model, {}))


def get_pretrained_cfg(model: str, tag: str) -> Optional[dict]:
    return PRETRAINED.get(model, {}).get(tag.lower())


def default_cache_dir() -> Path:
    return Path(os.environ.get("CLIPSELF_CACHE", Path.home() / ".cache" / "clipself_tpu"))


def cached_file(cfg: dict, cache_dir: Optional[str] = None) -> Optional[str]:
    """The local file of a catalog entry where the JAX package's
    `download_pretrained` leaves it, or None: a URL's basename in the cache
    directory; a hub entry's `filename` (default
    `open_clip_pytorch_model.bin`) in a snapshot of the hub cache layout
    (`models--<org>--<name>/snapshots/<revision>/`) under it."""
    cache = Path(cache_dir) if cache_dir else default_cache_dir()
    if cfg.get("hf_hub"):
        filename = cfg.get("filename") or "open_clip_pytorch_model.bin"
        repo = cache / ("models--" + cfg["hf_hub"].replace("/", "--")) / "snapshots"
        found = sorted(repo.glob(f"*/{filename}")) if repo.is_dir() else []
        return str(found[-1]) if found else None
    target = cache / cfg["url"].split("/")[-1]
    return str(target) if target.exists() else None


def resolve_pretrained(model: str, pretrained: str, cache_dir: Optional[str] = None) -> str:
    """Map a `pretrained` value to a local checkpoint path: an existing
    local path as it is; a catalog tag of ``model`` to its cached file.
    An unknown tag raises the JAX package's FileNotFoundError; a known tag
    whose file is not cached raises too, naming where it comes from (this
    package downloads nothing)."""
    if os.path.exists(pretrained):
        return pretrained
    cfg = get_pretrained_cfg(model, pretrained)
    if cfg is None:
        raise FileNotFoundError(
            f"'{pretrained}' is neither a local path nor a known tag for {model}; "
            f"known tags: {list_pretrained_tags_by_model(model)}"
        )
    path = cached_file(cfg, cache_dir)
    if path is None:
        source = (f"hub repo {cfg['hf_hub']} file {cfg.get('filename') or 'open_clip_pytorch_model.bin'}"
                  if cfg.get("hf_hub") else cfg["url"])
        cache = cache_dir or default_cache_dir()
        raise FileNotFoundError(
            f"'{pretrained}' of {model} is not in the cache {cache} and is not downloaded "
            f"here (ROADMAP.md queue 1 item 10): fetch {source} into it, or pass the file's path"
        )
    return path
