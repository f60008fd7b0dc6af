"""Offline profiling tables (port of ``repro.core.profiles``).

Per device-model pair p and complexity group g: inference time T[p, g]
(ms), energy E[p, g] (mWh, excluding idle base power) and accuracy
mAP[p, g] (0..100), as float32 tensors of shape (P, G). The ``.npz``
format of :meth:`ProfileTable.save` / :meth:`ProfileTable.load` is the JAX
package's, so a fleet saved by either package loads in the other."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

f32 = torch.float32

GROUP_NAMES = ("0_objects", "1_object", "2_objects", "3_objects", "4plus")


@dataclass
class ProfileTable:
    """Per-(pair, group) profiling table: the paper's offline measurements.

    ``T``/``E``/``mAP`` are float32 tensors of shape ``(P, G)`` (or
    ``(F, P, G)`` for a stacked fleet ensemble); ``floor_mw`` is ``(P,)``
    active-floor power above idle, or ``None``. All leaves live on one
    device; :meth:`to` moves them."""

    T: torch.Tensor            # (P, G) ms
    E: torch.Tensor            # (P, G) mWh / request
    mAP: torch.Tensor          # (P, G) in [0, 100]
    names: tuple[str, ...] = ()
    floor_mw: torch.Tensor | None = None

    @property
    def n_pairs(self) -> int:
        return self.T.shape[-2]

    @property
    def n_groups(self) -> int:
        return self.T.shape[-1]

    @property
    def is_stacked(self) -> bool:
        """True when the leaves carry a leading fleet axis (F, P, G)."""
        return self.T.ndim == 3

    @property
    def device(self) -> torch.device:
        return self.T.device

    def to(self, device=None) -> "ProfileTable":
        """The same table on ``device`` (``None``: the CUDA device)."""
        dev = resolve_device(device)
        return ProfileTable(
            self.T.to(dev), self.E.to(dev), self.mAP.to(dev), self.names,
            None if self.floor_mw is None else self.floor_mw.to(dev))

    def save(self, path: str) -> None:
        np.savez(path, T=self.T.cpu().numpy(), E=self.E.cpu().numpy(),
                 mAP=self.mAP.cpu().numpy(),
                 floor_mw=self.floor_mw.cpu().numpy()
                 if self.floor_mw is not None
                 else np.zeros(self.T.shape[:-1]),
                 names=np.array(self.names, dtype=object))

    @classmethod
    def load(cls, path: str) -> "ProfileTable":
        """Load a table written by :meth:`save` (either package) onto the
        CPU; :meth:`to` moves it."""
        z = np.load(path, allow_pickle=True)
        return profile_from_numpy(z["T"], z["E"], z["mAP"],
                                  tuple(z["names"].tolist()), z["floor_mw"])


def profile_from_numpy(T, E, mAP, names=(), floor_mw=None) -> ProfileTable:
    """A CPU :class:`ProfileTable` from array-likes (numpy arrays, or the
    JAX package's tables passed through ``np.asarray``), cast to float32.
    This is how a fleet crosses from the JAX package into the port."""

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return ProfileTable(t(T), t(E), t(mAP), tuple(names),
                        None if floor_mw is None else t(floor_mw))


def paper_fleet() -> ProfileTable:
    """The 5-node heterogeneous testbed of Table I/II (the JAX package's
    ``paper_fleet``, same constants), on the CPU:

      n1 pi5-tpu/ssd_v1     fastest (Table I best inference time; best mAP G1)
      n2 pi5-tpu/ssd_lite   cheap + fast (best mAP G2)
      n3 pi5-aihat/yolov8s  most accurate on complex scenes (best mAP G4/G5)
      n4 orin/yolov8s       accurate, faster, energy-hungry (best mAP G3)
      n5 orin/ssd_v1        lowest energy (Table I best energy)
    """
    names = ("pi5tpu/ssd_v1", "pi5tpu/ssd_lite", "pi5aihat/yolov8s",
             "orin/yolov8s", "orin/ssd_v1")
    T = [
        [92.0, 96.0, 100.0, 105.0, 110.0],
        [122.0, 126.0, 130.0, 136.0, 142.0],
        [390.0, 395.0, 400.0, 405.0, 410.0],
        [145.0, 148.0, 150.0, 153.0, 156.0],
        [112.0, 116.0, 120.0, 125.0, 130.0],
    ]
    E = [
        [0.10, 0.10, 0.11, 0.11, 0.12],
        [0.07, 0.07, 0.08, 0.08, 0.09],
        [0.38, 0.39, 0.40, 0.41, 0.42],
        [0.26, 0.27, 0.28, 0.29, 0.30],
        [0.04, 0.04, 0.05, 0.05, 0.06],
    ]
    mAP = [
        [76.0, 68.0, 56.0, 30.0, 14.0],
        [70.0, 78.5, 52.0, 26.0, 11.0],
        [75.0, 78.0, 78.5, 79.5, 80.0],
        [74.0, 77.0, 79.0, 78.0, 77.0],
        [71.0, 67.0, 53.0, 28.0, 12.0],
    ]
    floor = [60.0, 55.0, 225.0, 300.0, 250.0]
    return profile_from_numpy(T, E, mAP, names, floor)


def synthetic_fleet(generator: torch.Generator, n_pairs: int,
                    n_groups: int = 5,
                    frac_strong: float = 0.4) -> ProfileTable:
    """Random heterogeneous fleet for scale tests, drawn from
    ``generator`` on its device: ``frac_strong`` of pairs are
    accurate-but-slow ("yolo-class"), the rest fast-but-weak on complex
    scenes ("ssd-class").

    The distributions are those of the JAX package's ``synthetic_fleet``,
    but the draws come from a ``torch.Generator``, not from JAX's threefry
    stream, so one seed gives a different fleet in each package. To run
    both packages on one fleet, draw it in one and carry it across with
    :func:`profile_from_numpy`."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    strong = torch.rand((n_pairs, 1), generator=generator,
                        device=dev) < frac_strong
    base_T = torch.where(strong, 120.0, 40.0) * uniform((n_pairs, 1),
                                                        0.7, 1.4)
    slope = torch.linspace(1.0, 1.3, n_groups, device=dev)[None, :]
    T = base_T * slope
    E = torch.where(strong, 0.28, 0.09) * uniform((n_pairs, 1), 0.6, 1.4) \
        * slope
    g = torch.linspace(0.0, 1.0, n_groups, device=dev)[None, :]
    strong_map = 74.0 + 6.0 * g
    weak_map = 70.0 - 60.0 * g
    noise = uniform((n_pairs, n_groups), -3.0, 3.0)
    mAP = torch.clamp(torch.where(strong, strong_map, weak_map) + noise,
                      1.0, 99.0)
    names = tuple(f"pair{i}" for i in range(n_pairs))
    floor = torch.where(strong[:, 0], 500.0, 150.0)
    return ProfileTable(T, E, mAP, names, floor)
