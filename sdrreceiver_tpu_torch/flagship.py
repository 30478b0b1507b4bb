"""The receiver configurations the port is driven and measured with.

The same numbers as ``__graft_entry__`` (which imports the JAX ``graph``
package, so it cannot be used here):

  benchmark_config  the flagship, 27-channel sdr_25E-class configuration
                    (``_benchmark_config``): 1.536 Msps u8 IQ with DC
                    correction, 2 main-VFO groups (384 kHz and 192 kHz) and
                    27 sub-VFOs in three decimation schedules (11 x 12 kHz,
                    1 x 24 kHz, 15 x 48 kHz)
  altrate_config    the 1.92 Msps late-/5 configuration (``_altrate_config``,
                    sdr_54W_all.ini's shape): 2 main groups at 240 kHz,
                    /5-late subs at 12 kHz (2 cascade stages) and 48 kHz
"""

from __future__ import annotations

from .graph.config import MainVfoConfig, ReceiverConfig, SubVfoConfig

__all__ = ["benchmark_config", "altrate_config"]


def benchmark_config() -> ReceiverConfig:
    center = 1545600000
    mains = (
        MainVfoConfig(frequency=1545116000, out_rate=384000),
        MainVfoConfig(frequency=1546096000, out_rate=192000),
    )
    subs = []
    for i in range(11):
        subs.append(
            SubVfoConfig(
                frequency=1545005000 + 9000 * i,
                topic=f"CH{i:03d}",
                gain=5.0,
                data_rate=600,
                filter_bandwidth=4000 if i % 3 == 0 else 0,
            )
        )
    subs.append(
        SubVfoConfig(
            frequency=1545124000, topic="CH011", gain=5.0, data_rate=1200
        )
    )
    for i in range(15):
        subs.append(
            SubVfoConfig(
                frequency=1546005000 + 11000 * i,
                topic=f"CH{12 + i:03d}",
                gain=4.0,
                data_rate=10500 if i < 8 else 8400,
                filter_bandwidth=10000 if i >= 8 else 0,
            )
        )
    return ReceiverConfig(
        sample_rate=1536000,
        center_frequency=center,
        zmq_address="tcp://*:6003",
        correct_dc_bias=True,
        main_vfos=mains,
        vfos=tuple(subs),
    )


def altrate_config() -> ReceiverConfig:
    mains = (
        MainVfoConfig(frequency=1545120000, out_rate=240000),
        MainVfoConfig(frequency=1546120000, out_rate=240000),
    )
    subs = [
        SubVfoConfig(
            frequency=1545014429 + 15000 * i, topic=f"AL{i:03d}", gain=4.0, data_rate=600
        )
        for i in range(3)
    ] + [
        SubVfoConfig(
            frequency=1546045422 + 16000 * i, topic=f"AH{i:03d}", gain=4.0, data_rate=10500
        )
        for i in range(3)
    ]
    return ReceiverConfig(
        sample_rate=1920000,
        center_frequency=1545939000,
        zmq_address="tcp://*:6004",
        correct_dc_bias=True,
        main_vfos=mains,
        vfos=tuple(subs),
    )
