"""QSettings-ini-compatible configuration loading.

Stdlib-only port of ``sdrreceiver_tpu.graph.config`` (that package's
``graph/__init__`` imports its jax compiler, so the planner is ported here
rather than imported).

Reads the exact ini schema the reference consumes (README.md:29-92,
mainwindow.cpp:27-235): global keys at the top, plus two QSettings arrays
``[main_vfos]`` and ``[vfos]`` using the ``N\\key=value`` / ``size=N``
convention.  Unknown keys are ignored — which is load-bearing: the shipped
sample inis carry a recurring ``fiter_bandwidth`` typo that silently leaves
the audio filter off (e.g. sample_ini/sdr_25E.ini VFOs 1-18), and the new
framework must behave identically on those files.
"""

from __future__ import annotations

import dataclasses
import pathlib

__all__ = [
    "MainVfoConfig",
    "SubVfoConfig",
    "ReceiverConfig",
    "load_ini",
    "parse_ini_text",
    "SUPPORTED_SAMPLE_RATES",
]

#: The validated input rates (mainwindow.h:29, mainwindow.cpp:39-47).
SUPPORTED_SAMPLE_RATES = (288000, 1536000, 1920000)


@dataclasses.dataclass(frozen=True)
class MainVfoConfig:
    """One ``[main_vfos]`` entry (mainwindow.cpp:101-138)."""

    frequency: int
    out_rate: int
    zmq_address: str = ""
    zmq_topic: str = ""
    compress_scale: int = 0  # 0 = unset -> scale 1


@dataclasses.dataclass(frozen=True)
class SubVfoConfig:
    """One ``[vfos]`` entry (mainwindow.cpp:146-233)."""

    frequency: int
    topic: str
    gain: float = 0.0  # raw ini value; effective gain = gain/100
    data_rate: int = 0
    out_rate: int = 0
    filter_bandwidth: int = 0


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Full receiver configuration (global keys: mainwindow.cpp:29-96)."""

    sample_rate: int
    center_frequency: int
    zmq_address: str = ""
    tuner_gain: int = 496  # default mainwindow.cpp:13
    correct_dc_bias: bool = False
    mix_offset: int = 0
    remote_rtl: str = ""
    remote_rtl_gain_idx: int = 0
    #: The reference's auto_start clicks "Start" at launch when set
    #: (mainwindow.cpp:290-350).  This CLI is headless and ALWAYS starts
    #: (``run`` is the start button); the tuner-selection and bias-tee
    #: sub-keys below are honored by ``cli run`` for local USB devices.
    auto_start: bool = False
    auto_start_tuner_serial: str = ""
    auto_start_tuner_idx: int = 0
    auto_start_biast: bool = False
    #: The reference's disable_fft unchecks the GUI spectrum at auto-start
    #: (mainwindow.cpp:344-349) purely to save CPU.  Here the scope is OFF
    #: unless requested (``run --scope``), so every config runs as if
    #: disable_fft=1; the key is parsed for schema compatibility and a
    #: ``run --scope`` invocation deliberately overrides it (explicit flag
    #: beats ini default).  Documented in PARITY.md.
    disable_fft: bool = False
    main_vfos: tuple[MainVfoConfig, ...] = ()
    vfos: tuple[SubVfoConfig, ...] = ()

    def validate(self) -> None:
        if self.sample_rate == 0:
            raise ValueError("sample_rate key not found or zero")
        if self.sample_rate not in SUPPORTED_SAMPLE_RATES:
            raise ValueError(
                f"sample_rate {self.sample_rate} unsupported; "
                f"only {SUPPORTED_SAMPLE_RATES} are supported"
            )


def _parse_sections(text: str) -> dict[str, dict[str, str]]:
    """Minimal QSettings-ini reader: ``#``/``;`` comments, ``[section]``
    headers, ``key=value`` lines (whitespace-tolerant), later keys win."""
    sections: dict[str, dict[str, str]] = {"": {}}
    current = ""
    for rawline in text.splitlines():
        line = rawline.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            current = line[1:-1].strip().lower()
            sections.setdefault(current, {})
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        sections[current][key.strip()] = value.strip()
    return sections


def _to_int(v: str | None, default: int = 0) -> int:
    if v is None or v == "":
        return default
    try:
        return int(float(v)) if "." in v or "e" in v.lower() else int(v)
    except ValueError:
        return default  # QSettings .toInt() yields 0 on junk


def _to_float(v: str | None, default: float = 0.0) -> float:
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _read_array(section: dict[str, str]) -> list[dict[str, str]]:
    """Decode QSettings array entries ``N\\key=value`` with 1-based N."""
    size = _to_int(section.get("size"), 0)
    entries: list[dict[str, str]] = [dict() for _ in range(size)]
    for key, value in section.items():
        if "\\" not in key:
            continue
        idx_s, _, sub = key.partition("\\")
        try:
            idx = int(idx_s)
        except ValueError:
            continue
        if 1 <= idx <= size:
            entries[idx - 1][sub.strip().lower()] = value
    return entries


def parse_ini_text(text: str) -> ReceiverConfig:
    sections = _parse_sections(text)
    g = sections.get("", {})
    # QSettings also files top-level keys under [General]
    g = {**sections.get("general", {}), **g}
    glow = {k.lower(): v for k, v in g.items()}

    mains = []
    for e in _read_array(sections.get("main_vfos", {})):
        mains.append(
            MainVfoConfig(
                frequency=_to_int(e.get("frequency")),
                out_rate=_to_int(e.get("out_rate")),
                zmq_address=e.get("zmq_address", ""),
                zmq_topic=e.get("zmq_topic", ""),
                compress_scale=_to_int(e.get("compress_scale")),
            )
        )

    subs = []
    for e in _read_array(sections.get("vfos", {})):
        subs.append(
            SubVfoConfig(
                frequency=_to_int(e.get("frequency")),
                topic=e.get("topic", ""),
                gain=_to_float(e.get("gain")),
                data_rate=_to_int(e.get("data_rate")),
                out_rate=_to_int(e.get("out_rate")),
                filter_bandwidth=_to_int(e.get("filter_bandwidth")),
            )
        )

    return ReceiverConfig(
        sample_rate=_to_int(glow.get("sample_rate")),
        center_frequency=_to_int(glow.get("center_frequency")),
        zmq_address=glow.get("zmq_address", ""),
        # default 496, overridden only by a positive ini value
        # (mainwindow.cpp:13,83-87)
        tuner_gain=(
            _to_int(glow.get("tuner_gain"), 0)
            if _to_int(glow.get("tuner_gain"), 0) > 0
            else 496
        ),
        correct_dc_bias=glow.get("correct_dc_bias") == "1",
        mix_offset=_to_int(glow.get("mix_offset")),
        remote_rtl=glow.get("remote_rtl", ""),
        remote_rtl_gain_idx=_to_int(glow.get("remote_rtl_gain_idx")),
        auto_start=_to_int(glow.get("auto_start")) == 1,
        auto_start_tuner_serial=glow.get("auto_start_tuner_serial", ""),
        auto_start_tuner_idx=_to_int(glow.get("auto_start_tuner_idx")),
        auto_start_biast=_to_int(glow.get("auto_start_biast")) == 1,
        disable_fft=_to_int(glow.get("disable_fft")) == 1,
        main_vfos=tuple(mains),
        vfos=tuple(subs),
    )


def load_ini(path: str | pathlib.Path) -> ReceiverConfig:
    p = pathlib.Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"settings ini file doesn't exist: {p}")
    return parse_ini_text(p.read_text())
