"""Int8 MobileNet-V2 1.0-224 on the N-EUREKA path — the paper's workload.

Ports ``repro/models/mobilenet_v2.py``.  Every convolution runs as one
N-EUREKA job (dense3x3 / dw3x3 / pw1x1 through
``kernels.ops.neureka_conv2d``) on packed 2/4/8-bit weights, in the order
of the job list the analytical model walks
(``core.perf_model.mobilenet_v2_jobs``).  On CUDA tensors the jobs launch
the Hopper kernels (``conv3x3_dense`` once, ``conv3x3_dw`` 17 times and
``qmatmul_int8`` 35 times a frame at 224); on CPU tensors they run the
plain PyTorch versions.

The weights are random: ``init_params`` draws them from a
``torch.Generator``, whose numbers differ from ``jax.random``'s, so parity
tests carry the reference's trees over with ``repro_torch.interop``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.device import DeviceLike, device_of, resolve_device
from repro_torch.core.memsys import LayerShape
from repro_torch.core.perf_model import mobilenet_v2_jobs
from repro_torch.kernels import ops as kops

Params = Dict[str, Dict[str, torch.Tensor]]


def _weight_shape(job: LayerShape):
    if job.op_kind == "dense3x3":
        return (job.cout, 3, 3, job.cin)
    if job.op_kind == "dw3x3":
        return (job.cin, 3, 3)
    return (job.cout, job.cin)


def init_params(generator: Optional[torch.Generator] = None,
                weight_bits: int = 8, img: int = 224,
                device: DeviceLike = None) -> Params:
    """Float master weights for every job (to be frozen / packed), drawn on
    the generator's device (default: a CPU generator seeded 0) as N(0, 1) /
    sqrt(fan_in), with zero biases, and moved to ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Params = {}
    for job in mobilenet_v2_jobs(weight_bits, img):
        shape = _weight_shape(job)
        fan_in = 1
        for d in shape[1:]:
            fan_in *= d
        w = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=g.device) * fan_in ** -0.5
        params[job.name] = dict(
            w=w.to(dev), bias=torch.zeros((shape[0],), dtype=torch.float32,
                                          device=dev))
    return params


def packing_levels(packed: torch.Tensor, bits: int, shape) -> torch.Tensor:
    """Signed levels of a packed job weight, one row per output channel."""
    return packing.unpack(packed, bits, shape[-1]).reshape(shape[0], -1)


def freeze_packed(params: Params, weight_bits: int = 8,
                  img: int = 224) -> Params:
    """Quantize + pack every job's weights and fold the requant parameters,
    on the device the weights lie on.

    As the reference: per-channel ``mult = 40 / (128 * max(rms(levels),
    1e-3) * sqrt(K))`` maps each int32 accumulator's spread onto ~40 LSB,
    and ``bias = 128 + round(bias_fp)`` centres the unsigned output.  The
    rms is a float32 mean whose summation order may differ from XLA's, so
    ``mult`` agrees with the reference to ~1e-7 relative, while ``packed``
    and ``bias`` are identical.
    """
    out: Params = {}
    in_rms = 128.0                     # running estimate of input-act RMS
    for job in mobilenet_v2_jobs(weight_bits, img):
        p = params[job.name]
        if job.op_kind == "dense3x3":
            packed, _ = kops.prep_conv3x3(p["w"], weight_bits)
            k_red = 9 * job.cin
            lv = packing_levels(packed, weight_bits, (job.cout, 3, 3, job.cin))
        elif job.op_kind == "dw3x3":
            packed, _ = kops.prep_dw3x3(p["w"], weight_bits)
            k_red = 9
            lv = packing_levels(packed, weight_bits, (job.cin, 9))
        else:
            packed, _ = kops.prep_linear(p["w"], weight_bits)
            k_red = job.cin
            lv = packing_levels(packed, weight_bits, (job.cout, job.cin))
        lv_rms = torch.sqrt(torch.mean(lv.to(torch.float32) ** 2, dim=1))
        acc_std = in_rms * torch.clamp(lv_rms, min=1e-3) * (k_red ** 0.5)
        # a true division: ``40.0 / t`` is ``t.reciprocal() * 40`` in torch
        mult = torch.full_like(acc_std, 40.0) / acc_std
        bias = torch.full((lv.shape[0],), 128, dtype=torch.int32,
                          device=lv.device)
        out[job.name] = dict(packed=packed, mult=mult.to(torch.float32),
                             bias=bias + torch.round(p["bias"]).to(torch.int32))
    return out


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 -> (1, 1, C) uint8, equal to the reference's
    ``jnp.mean(x.astype(f32), (0, 1)).astype(uint8)``.

    The reference's f32 sum of uint8 values is exact and its quotient is
    rounded once, so it truncates to floor(sum / (H*W)): a quotient that is
    not an integer lies at least 1/(H*W) below the next one, far more than
    its rounding error.  The port computes that floor in integers, which no
    device can round differently; a float pool on the card would not be
    safe, since PyTorch's CUDA mean, and its division by a Python number,
    multiply by a rounded reciprocal and can land just under an exact
    multiple.
    """
    h, w, _ = x.shape
    s = x.to(torch.int32).sum(dim=(0, 1), keepdim=True)
    return torch.div(s, h * w, rounding_mode="floor").to(torch.uint8)


def apply(packed_params: Params, image_q: torch.Tensor, *,
          weight_bits: int = 8, img: int = 224) -> torch.Tensor:
    """Run int8 MobileNet-V2.  image_q: (H, W, 3) uint8 -> logits (1000,)
    uint8, on the device of ``image_q`` and the frozen tree.

    Residual adds follow NEMO integer semantics: uint8 feature maps added
    in int32 around 128, then clipped back to uint8.
    """
    dev = device_of(packed_params)
    if dev is not None and image_q.device != dev:
        raise ValueError(f"image on {image_q.device}, weights on {dev}")
    x = image_q
    residual: Optional[torch.Tensor] = None
    for job in mobilenet_v2_jobs(weight_bits, img):
        p = packed_params[job.name]
        if job.name == "fc":
            x = avg_pool(x)
        new_x = kops.neureka_conv2d(
            x, p["packed"], p["mult"], p["bias"], op=job.op_kind,
            bits=weight_bits, cin=job.cin, stride=job.stride)
        # inverted-residual skip around (pw_exp, dw, pw_proj) triples with
        # stride 1 and matching shapes
        if job.name.endswith(".pw_exp"):
            residual = x
        if job.name.endswith(".pw_proj"):
            if (residual is not None and job.stride == 1
                    and new_x.shape == residual.shape):
                s = residual.to(torch.int32) + new_x.to(torch.int32) - 128
                new_x = torch.clamp(s, 0, 255).to(torch.uint8)
            residual = None
        x = new_x
    return x.reshape(-1)


def job_list(weight_bits: int = 8, img: int = 224) -> List[LayerShape]:
    return mobilenet_v2_jobs(weight_bits, img)

