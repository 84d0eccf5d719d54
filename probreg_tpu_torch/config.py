"""Global configuration of the PyTorch / CUDA port.

Counterpart of ``probreg_tpu/config.py``, keeping the knobs that still mean
something off the TPU. The dispatch thresholds have the reference's values,
so the port takes the same branch as the reference for the same sizes.
Every knob is read per call: there is no compiled program to invalidate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Config:
    # Device that entry points move numpy inputs to. The port never falls
    # back to the CPU on its own: see resolve_device.
    device: str = "cuda"
    # dtype used for point clouds and EM state.
    dtype: torch.dtype = torch.float32
    # Target-block size of the streaming plain E-step (ops/estep.estep_xla).
    estep_chunk: int = 4096
    # Largest M*N routed to the one-launch E-step kernel (estep_small).
    small_estep_max_pairs: int = 1024 * 1024
    # Smallest M*N routed to the Morton-sorted tile-culled stash E-step.
    culled_estep_min_pairs: int = 1 << 24
    # Largest M*N for the whole-EM dense loop (cpd._run_em_t), which holds
    # the (M, N) posterior; above it registration streams (cpd._run_em).
    transposed_em_max_pairs: int = 1 << 28
    # Run small 3-D rigid / affine pairs as one launch of the whole-EM
    # kernel (ops/em_cuda.py), up to this many pairs M*N.
    use_fused_em: bool = True
    fused_em_max_pairs: int = 1 << 20
    # Opt-in: the two-pass E-step kernels (estep_cuda.estep_fused) for
    # M*N >= pallas_min_pairs where no other kernel branch applies. The
    # names are the reference's, so both packages read one set of knobs.
    use_pallas: bool = False
    pallas_min_pairs: int = 1 << 22
    # Route large E-steps through the tile-culled stash kernels.
    use_culled_estep: bool = True
    # Source / target tile sizes of the stash E-step.
    tile_m: int = 512
    tile_n: int = 1024
    # The reference's pipelined stash E-step (estep_cuda.stash_merged_estep,
    # kernel stash_merged): K3's pass A, then pass B with the normalizer
    # folded into the channels for every stripe but the last, two launches
    # and no stash. The reference keeps a SECOND (M_padded, tile_n) stash
    # buffer, so its tiles here are those of half of stash_max_bytes. p1
    # and px differ from the default route only by rounding (the folded
    # normalizer); pt1 and xx are the same bit for bit.
    use_merged_stash: bool = False
    # Cap on the (M_padded, tile_n) f32 stash of the reference's CPD
    # E-step. No E-step of this package keeps a stash; the cap picks the
    # tiles and the branches where the reference's does. None derives it
    # from the device: an eighth of the card's memory, 1 GiB on the CPU.
    # Above it tile_n halves (floor 256); beyond the floor
    # estep_auto answers with the streaming plain E-step (estep_xla), as
    # the reference does, the sharded culled CPD runners (parallel/) raise,
    # and so does the BCPD E-step. The reference's cpd_stash_max_bytes
    # carries into it (interop.config_from_reference).
    stash_max_bytes: Optional[int] = None
    # Largest source cloud that BCPD runs through the row-weighted culled
    # stash E-step (ops/bcpd_cuda.py); above it the VI loop streams target
    # blocks. The value is the reference's, which it set after that
    # kernel faulted a TPU worker at 1M source points; it says nothing
    # about this card, and is kept so both packages take the same branch
    # at the same sizes.
    bcpd_culled_max_points: int = 750_000
    # Cap on the (M_padded, tile_n) f32 stash of the reference's BCPD
    # E-step. The port keeps no stash; the cap picks BCPD's tiles where the
    # reference's does (tile_n halves, floor 256, so the sums keep the
    # reference's order), and beyond the floor bcpd_estep_culled raises.
    # The name and the default are the reference's, so
    # interop.config_from_reference carries it as it is.
    bcpd_stash_max_bytes: int = 2 << 30


config = Config()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` or ``config.device``.

    Raises when that is a CUDA device and none is available, so a run never
    moves to the CPU unless the caller asked for it.
    """
    dev = torch.device(device if device is not None else config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "probreg_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' or set "
            "probreg_tpu_torch.config.config.device = 'cpu' to run on the CPU")
    return dev
