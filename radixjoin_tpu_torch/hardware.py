"""Hardware model of the port (counterpart of radixjoin_tpu/hardware.py).

The JAX package keeps a catalog of TPU generations and maps
``jax.devices()[0].device_kind`` onto it. The port keeps the same shape —
a :class:`ChipSpec` catalog and :func:`detect` — for CUDA cards. The tiers
that matter for a join engine on a Hopper card:

  * **HBM** — where tables live; its bandwidth bounds every scan, gather
    and scatter (the device-time harness reports kernels against
    ``hbm_gbps``).
  * **Shared memory** (up to ``smem_per_block_bytes`` per block after the
    opt-in) — the counterpart of the TPU's VMEM: a table staged there is
    read on chip.
  * **L2** (``l2_bytes``) — what a table too large for shared memory is
    read through.

:func:`detect` reads the card's own figures from
``torch.cuda.get_device_properties`` (name, memory, SM count, L2 size,
opt-in shared memory per block) and takes the published bandwidth of
its catalog entry, matched on the device name. The
TPU-only fields of the JAX catalog (ICI links, VPU lanes) have no
counterpart here and are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

MiB = 1 << 20
GiB = 1 << 30


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-device capabilities. A CUDA card's catalog entry holds only its
    published bandwidth; :func:`detect` fills the other fields from the
    card's own properties."""

    name: str
    #: lower-case substrings of the device name used for detection
    kinds: tuple
    hbm_gbps: float  # device-memory bandwidth, GB/s
    hbm_bytes: int = 0
    #: shared memory one block may use after the opt-in (the VMEM tier)
    smem_per_block_bytes: int = 0
    l2_bytes: int = 0
    sm_count: int = 0


CHIPS = {
    # NVIDIA H100 Tensor Core GPU datasheet: H100 SXM5, 3.35 TB/s HBM3. The
    # SXM card names itself "NVIDIA H100 80GB HBM3"; other H100 forms have
    # other bandwidths and stay outside the catalog.
    "h100_sxm": ChipSpec("h100_sxm", ("h100 80gb hbm3",), 3350.0),
    # The CPU (tests, dry runs): token numbers, never benched.
    "cpu": ChipSpec("cpu", ("cpu",), 50.0, 8 * GiB, 16 * MiB, 0, 1),
}


def _catalog_entry(device_name: str) -> Optional[ChipSpec]:
    low = device_name.lower()
    for spec in CHIPS.values():
        if any(k in low for k in spec.kinds):
            return spec
    return None


def detect(device=None) -> ChipSpec:
    """The spec of ``device``. The default is the current CUDA card, and
    raises where there is none; ``"cpu"`` gives the CPU entry on request. A
    CUDA card outside the catalog keeps its own properties with its
    bandwidth unknown (NaN)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hardware.detect(): CUDA is not available; pass 'cpu' for "
                "the CPU entry"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return CHIPS["cpu"]
    props = torch.cuda.get_device_properties(device)
    base = _catalog_entry(props.name)
    return ChipSpec(
        name=base.name if base else props.name,
        kinds=base.kinds if base else (props.name.lower(),),
        hbm_gbps=base.hbm_gbps if base else float("nan"),
        hbm_bytes=int(props.total_memory),
        smem_per_block_bytes=int(props.shared_memory_per_block_optin),
        l2_bytes=int(props.L2_cache_size),
        sm_count=int(props.multi_processor_count),
    )


def norm_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in, so that
    ``"cuda"`` and ``"cuda:0"`` name one memo key and one ledger."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
