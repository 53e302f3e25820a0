"""Three-term roofline model, by default for one NVIDIA H100 SXM.

  compute    t = FLOPs       / peak_flops   [dense bf16 per card]
  memory     t = bytes       / hbm_bw       [HBM per card]
  collective t = coll_bytes  / link_bw      [one card's link out of its node]

Every input is a per-device number (the dry run counts what one rank of
the mesh runs), so the terms are per-device times, equal to the global
terms over ``chips`` cards.  The default ``HardwareModel`` is NVIDIA's
H100 SXM data sheet at its 700 W limit: 989e12 dense bf16 FLOP/s and
3.35e12 HBM bytes/s.  Its collective rate is one ConnectX-7 NDR InfiniBand
port, 400 Gb/s = 50e9 bytes/s (NVIDIA's ConnectX-7 data sheet; one port a
card in an 8-card node): a 16-wide 'model' axis spans two 8-card NVLink
nodes, so its collectives cross that link.  Pass ``hw=`` for another card
or rate.

MODEL_FLOPS (the useful-work yardstick) is 6*N*D for training and 2*N*D for
inference, with N = active FLOP-bearing params (experts scaled by top_k/E,
input embedding excluded) and D = tokens processed by the step.
"""

from __future__ import annotations

import dataclasses

__all__ = ["H100", "HardwareModel", "RooflineTerms", "model_flops_for", "roofline"]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str = "h100_sxm"
    peak_flops: float = 989e12  # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12  # bytes/s per card
    ici_bw: float = 50e9  # bytes/s per card's inter-node link (ConnectX-7 NDR)


H100 = HardwareModel()


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    model_flops: float
    hlo_flops_global: float
    peak_flops: float = H100.peak_flops

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — remat/dispatch waste detector."""
        return self.model_flops / self.hlo_flops_global if self.hlo_flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU upper bound: useful-FLOP time / bound time, the
        useful FLOPs at the terms' own peak."""
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        return t_useful / self.bound_time if self.bound_time else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    chips: int,
    model_flops: float,
    hw: HardwareModel = H100,
) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops_per_device / hw.peak_flops,
        t_memory=bytes_per_device / hw.hbm_bw,
        t_collective=coll_bytes_per_device / hw.ici_bw,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        chips=chips,
        model_flops=model_flops,
        hlo_flops_global=flops_per_device * chips,
        peak_flops=hw.peak_flops,
    )


def model_flops_for(cfg, shape) -> float:
    """6ND (train) / 2ND (inference) with N = active FLOP-bearing params."""
    from repro_torch.models.model import count_params_analytic

    n = count_params_analytic(cfg, active_only=True, exclude_embed=True)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
