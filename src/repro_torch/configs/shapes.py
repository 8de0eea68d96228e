"""The assigned input-shape cells (seq_len x global_batch) for every arch
(reference: ``repro/configs/shapes.py``).

``train_*`` cells run the train step; ``prefill_*`` the serve prefill;
``decode_*`` / ``long_*`` the serve decode step (one new token against a
KV / SSM cache of seq_len).  long_500k requires sub-quadratic attention: it
runs for the SSM / hybrid archs and is SKIPPED for pure full-attention
archs, as in the reference.  ``launch/dryrun.py`` counts every cell.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# archs with sub-quadratic sequence mixing (SSM / sliding-window hybrid)
SUBQUADRATIC = ("hymba-1.5b", "falcon-mamba-7b")


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True
