"""Architecture registry (reference: ``repro/configs/__init__.py``).

``get_config(name)`` / ``ARCHS`` are the public API.  The ten arch configs
are plain values copied from the reference; the port serves and trains
every family (the decoder-only ones in ``models/transformer.py``, the
encoder-decoder in ``models/encdec.py``).
"""

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.gemma_7b import CONFIG as _gemma
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon
from repro_torch.configs.llava_next_34b import CONFIG as _llava

ARCHS = {c.name: c for c in (
    _qwen3, _qwen25, _olmo, _gemma, _whisper, _qwen2moe, _arctic, _hymba,
    _falcon, _llava)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
