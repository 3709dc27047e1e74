"""Described device topologies — the compiler's view of the machine.

The port's copy of ``repro.core.topology``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

The paper's compiler places a costed dataflow graph onto "a number of
individual computing devices ... with potentially varying computational
capabilities" connected by links of known bandwidth.  Historically this repo
passed a bare ``k: int`` (plus an implicit :class:`DeviceSpec`) through every
planning signature; :class:`Topology` replaces that with a first-class
artifact: an ordered list of :class:`DeviceSpec` entries plus a pairwise
interconnect-bandwidth matrix, serializable to JSON so a plan compiled for a
machine can name the machine it was compiled for.

Construction::

    topo = Topology.homogeneous(8)                  # 8 x TPU v5e, ICI mesh
    topo = Topology.heterogeneous([0.5, 1.0, 1.0])  # mixed speed factors
    topo = Topology.from_json(json.load(open(p)))   # a described machine

The bandwidth matrix defaults to ``min(link_bw_i, link_bw_j)`` for every
pair — a uniform all-to-all fabric at per-device link speed — and may be
overridden entry-wise to describe hierarchical fabrics (fast intra-host,
slow inter-host).  ``fingerprint()`` is the stable content hash used in
:mod:`repro_torch.core.plan` cache keys.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Sequence

from .cost_model import TPU_V5E, DeviceSpec

TOPOLOGY_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Topology:
    """An ordered set of devices plus their interconnect bandwidths.

    ``bandwidth`` is either ``None`` — the uniform default fabric, where
    every pair talks at ``min(link_bw_i, link_bw_j)``, represented
    implicitly so large homogeneous topologies stay O(k) to hash and
    serialize — or an explicit k x k matrix whose ``[i][j]`` entry is the
    bytes/s device ``i`` can move to device ``j`` (diagonal entries are
    unused; a zero off-diagonal entry means *no link*).  Heterogeneity is
    expressed through the individual :class:`DeviceSpec` entries; the
    matrix captures fabric asymmetry the per-device ``link_bw`` scalar
    cannot.
    """

    devices: tuple[DeviceSpec, ...]
    bandwidth: Optional[tuple[tuple[float, ...], ...]] = None

    def __post_init__(self) -> None:
        k = len(self.devices)
        if k == 0:
            raise ValueError("a Topology needs at least one device")
        if self.bandwidth is not None:
            bad = len(self.bandwidth) != k
            bad = bad or any(len(row) != k for row in self.bandwidth)
            if bad:
                raise ValueError(f"bandwidth matrix must be {k}x{k} to match devices")

    # -- constructors ---------------------------------------------------------
    @classmethod
    def homogeneous(cls, k: int, spec: DeviceSpec = TPU_V5E) -> "Topology":
        """``k`` identical devices on a uniform fabric (the legacy ``k: int``)."""
        devices = tuple(
            dataclasses.replace(spec, name=f"{spec.name}[{i}]") for i in range(k)
        )
        return cls(devices)

    @classmethod
    def heterogeneous(
        cls, speed_factors: Sequence[float], base: DeviceSpec = TPU_V5E
    ) -> "Topology":
        """Devices sharing ``base`` dims but with per-device speed factors."""
        devices = tuple(
            dataclasses.replace(base, name=f"{base.name}[{i}]", speed_factor=s)
            for i, s in enumerate(speed_factors)
        )
        return cls(devices)

    @classmethod
    def from_devices(
        cls,
        devices: Sequence[DeviceSpec],
        bandwidth: Optional[Sequence[Sequence[float]]] = None,
    ) -> "Topology":
        devices = tuple(devices)
        if bandwidth is None:
            return cls(devices)
        bw = tuple(tuple(float(x) for x in row) for row in bandwidth)
        return cls(devices, bw)

    # -- queries --------------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def link_bw(self, src: int, dst: int) -> float:
        """Bytes/s from device ``src`` to device ``dst`` (0.0 on the
        diagonal; on the implicit uniform fabric, the slower endpoint's
        link speed)."""
        if src == dst:
            return 0.0
        if self.bandwidth is None:
            return min(self.devices[src].link_bw, self.devices[dst].link_bw)
        return self.bandwidth[src][dst]

    def is_homogeneous(self) -> bool:
        d0 = dataclasses.replace(self.devices[0], name="")
        return all(dataclasses.replace(d, name="") == d0 for d in self.devices[1:])

    def describe(self) -> str:
        kinds = {d.name.split("[")[0] for d in self.devices}
        speeds = sorted({d.speed_factor for d in self.devices})
        fabric = set()
        if self.bandwidth is None:
            fabric = {d.link_bw for d in self.devices}
        else:
            for i, row in enumerate(self.bandwidth):
                for j, bw in enumerate(row):
                    if i != j:
                        fabric.add(bw)
        links = [f"{bw / 1e9:.0f}GB/s" for bw in sorted(fabric)]
        return (
            f"Topology(k={self.k}, devices={'/'.join(sorted(kinds))}, "
            f"speed_factors={speeds}, link_bw={links})"
        )

    # -- serialization --------------------------------------------------------
    def to_json(self) -> dict:
        # null = the implicit uniform fabric (kept implicit so large
        # homogeneous topologies don't serialize an O(k^2) matrix)
        bw = None if self.bandwidth is None else [list(r) for r in self.bandwidth]
        return {
            "version": TOPOLOGY_SCHEMA_VERSION,
            "devices": [dataclasses.asdict(d) for d in self.devices],
            "bandwidth": bw,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Topology":
        version = doc.get("version", TOPOLOGY_SCHEMA_VERSION)
        if version != TOPOLOGY_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported topology schema version {version} "
                f"(this build reads version {TOPOLOGY_SCHEMA_VERSION})"
            )
        devices = tuple(DeviceSpec(**d) for d in doc["devices"])
        return cls.from_devices(devices, doc.get("bandwidth"))

    def fingerprint(self) -> str:
        """Stable content hash (hex) — part of every compiled-plan key."""
        blob = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]
