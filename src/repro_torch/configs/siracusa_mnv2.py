"""The paper's own workload: int8 MobileNet-V2 1.0-224 on N-EUREKA with
2-8 bit packed weights in the At-MRAM store (paper section IV; reference:
``repro/configs/siracusa_mnv2.py``).  ``models/mobilenet_v2.py`` runs it."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class MNV2Config:
    name: str = "siracusa-mnv2"
    img: int = 224
    weight_bits: int = 8
    scenario: str = "l1mram"


CONFIG = MNV2Config()
