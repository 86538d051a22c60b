"""Configuration dataclass + the VAQ method-string DSL.

Behavioral parity with the reference C++ engine's configuration surface:

* ``VAQ::NNMethod`` flag enum      (reference ``bitvecengine/VAQ.hpp:38-49``)
* ``VAQ::parseMethodString``       (reference ``bitvecengine/VAQ.cpp:1189-1267``)
* hardcoded bit-allocation strings (reference ``utils/Experiment.hpp:213-230``)

The grammar (comma-separated tokens)::

    VAQ{budget}m{subspaces}min{minbits}max{maxbits}var{pct}
    SORT | HEAP | EA | TI{c} | TI{c}var{v} | TI{c}m{s} | FAST | FAST2 | FAST3

method tokens may be combined with underscores, e.g. ``EA_TI100var0.9``.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional, Tuple

from vaq_tpu.errors import ConfigError


class SearchMethod(enum.IntFlag):
    """Scan-strategy bitmask, value-compatible with the reference enum."""

    SORT = 0x01
    EA = 0x02      # early abandon (CPU idiom; maps to the exhaustive scan)
    TI = 0x04      # triangle-inequality cluster pruning -> IVF-style cluster probe
    FAST = 0x08    # u8-quantized-LUT scan (reference: AVX2 shuffle)
    FAST2 = 0x10   # f32-LUT scan (reference: AVX2 gather)
    FAST3 = 0x20   # hybrid: u8 LUT for <=4-bit subspaces, f32 for the rest
    FAST4 = 0x40   # declared in the reference, no search impl there either
    HEAP = 0x80


@dataclasses.dataclass(frozen=True)
class VAQConfig:
    """Static configuration of a VAQ index.

    Defaults mirror the reference member initializers
    (``bitvecengine/VAQ.hpp:51-91``).
    """

    bit_budget: int = 256
    subspace_num: int = 32
    min_bits: int = 0
    max_bits: int = 8
    percent_var_explained: float = 1.0
    methods: SearchMethod = SearchMethod.SORT

    # Triangle-inequality / cluster-probe parameters.
    ti_cluster_num: int = -1
    ti_segment_num: int = -1
    ti_variance: float = 1.0
    visit: float = 1.0          # fraction of clusters visited per query

    # Codebook training.
    hierarchical_kmeans: bool = False
    binary_kmeans: bool = False
    kmeans_iters: int = 25
    seed: int = 13517106        # the reference's fixed RNG seed (Random.hpp:15)

    # Optional override of the ILP bit allocation (--hc-bitalloc).
    hardcoded_bits: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if (self.methods & SearchMethod.FAST) and self.max_bits > 4:
            # Same constraint as reference VAQ.cpp:1263-1266.
            raise ConfigError(
                "max bits per subspace cannot exceed 4 with the FAST method"
            )

    def with_methods(self, methods: SearchMethod) -> "VAQConfig":
        return dataclasses.replace(self, methods=methods)

    @property
    def max_centroids(self) -> int:
        return 1 << self.max_bits


_VAQ_RE = re.compile(
    r"VAQ(?P<budget>\d+)m(?P<subs>\d+)min(?P<minb>\d+)max(?P<maxb>\d+)"
    r"var(?P<var>[0-9.eE+-]+)"
)
_TI_VAR_RE = re.compile(r"TI(?P<c>\d+)var(?P<v>[0-9.eE+-]+)")
_TI_SEG_RE = re.compile(r"TI(?P<c>\d+)m(?P<s>\d+)")
_TI_RE = re.compile(r"TI(?P<c>\d+)")


def parse_method_string(method_string: str, base: Optional[VAQConfig] = None) -> VAQConfig:
    """Parse the reference's method-string DSL into a :class:`VAQConfig`.

    Mirrors ``VAQ::parseMethodString`` (VAQ.cpp:1189-1267): tokens are
    comma-separated; a ``VAQ...`` token sets the quantization parameters; a
    method token (optionally underscore-joined) resets and ORs the method
    bitmask; ``TI`` accepts ``TI{c}var{v}``, ``TI{c}m{s}`` or ``TI{c}``.
    """
    cfg = dataclasses.asdict(base) if base is not None else dataclasses.asdict(
        VAQConfig()
    )
    # IntFlag survives asdict, but normalize to be safe.
    cfg["methods"] = SearchMethod(cfg["methods"])

    for token in method_string.split(","):
        if token.startswith("VAQ"):
            m = _VAQ_RE.match(token)
            if m:
                cfg["bit_budget"] = int(m.group("budget"))
                cfg["subspace_num"] = int(m.group("subs"))
                cfg["min_bits"] = int(m.group("minb"))
                cfg["max_bits"] = int(m.group("maxb"))
                cfg["percent_var_explained"] = float(m.group("var"))
        elif any(s in token for s in ("SORT", "HEAP", "EA", "TI", "FAST", "FAST2")):
            methods = SearchMethod(0)
            for tm in token.split("_"):
                if "SORT" in tm:
                    methods |= SearchMethod.SORT
                elif "HEAP" in tm:
                    methods |= SearchMethod.HEAP
                elif "EA" in tm:
                    methods |= SearchMethod.EA
                elif "TI" in tm:
                    mv = _TI_VAR_RE.match(tm)
                    ms = _TI_SEG_RE.match(tm)
                    mc = _TI_RE.match(tm)
                    if mv:
                        methods |= SearchMethod.TI
                        cfg["ti_cluster_num"] = int(mv.group("c"))
                        cfg["ti_variance"] = float(mv.group("v"))
                    elif ms:
                        methods |= SearchMethod.TI
                        cfg["ti_cluster_num"] = int(ms.group("c"))
                        cfg["ti_segment_num"] = int(ms.group("s"))
                    elif mc:
                        methods |= SearchMethod.TI
                        cfg["ti_cluster_num"] = int(mc.group("c"))
                elif "FAST3" in tm:
                    methods |= SearchMethod.FAST3
                elif "FAST2" in tm:
                    methods |= SearchMethod.FAST2
                elif "FAST" in tm:
                    methods |= SearchMethod.FAST
            cfg["methods"] = methods

    return VAQConfig(**cfg)


def parse_hardcoded_bits(spec: str) -> Tuple[int, ...]:
    """Parse a hardcoded bit-allocation override.

    Mirrors ``parseVAQHardcode`` (utils/Experiment.hpp:213-230): a
    comma-separated list of ``{count}x{bits}`` runs or plain integers, e.g.
    ``"4x8,2x6,1x4"`` -> (8,8,8,8,6,6,4).
    """
    bits = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if "x" in token:
            count_s, bits_s = token.split("x", 1)
            bits.extend([int(bits_s)] * int(count_s))
        else:
            bits.append(int(token))
    return tuple(bits)


def format_method_string(cfg: VAQConfig) -> str:
    """Inverse of :func:`parse_method_string` (for logging/round-trips)."""
    var = cfg.percent_var_explained
    var_s = f"{var:g}"
    parts = [
        f"VAQ{cfg.bit_budget}m{cfg.subspace_num}min{cfg.min_bits}"
        f"max{cfg.max_bits}var{var_s}"
    ]
    methods = []
    if cfg.methods & SearchMethod.SORT:
        methods.append("SORT")
    if cfg.methods & SearchMethod.HEAP:
        methods.append("HEAP")
    if cfg.methods & SearchMethod.EA:
        methods.append("EA")
    if cfg.methods & SearchMethod.TI:
        t = f"TI{cfg.ti_cluster_num}"
        if cfg.ti_variance < 1.0:
            t += f"var{cfg.ti_variance:g}"
        elif cfg.ti_segment_num > 0:
            t += f"m{cfg.ti_segment_num}"
        methods.append(t)
    if cfg.methods & SearchMethod.FAST3:
        methods.append("FAST3")
    elif cfg.methods & SearchMethod.FAST2:
        methods.append("FAST2")
    elif cfg.methods & SearchMethod.FAST:
        methods.append("FAST")
    if methods:
        parts.append("_".join(methods))
    return ",".join(parts)
