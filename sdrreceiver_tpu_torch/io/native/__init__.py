"""Native (C++) ingest runtime loaded via ctypes: the reference's 20-slot
drop-on-full block ring and u8 LUT (jonti/sdr.cpp:100-184).

``ringbuffer.cpp`` is the JAX package's source with each slot's push time
and the ring's high-water depth added (the same C entry points besides);
``loader`` builds it with g++ at first use into ``build/``.
"""

from .loader import IngestRing, available, load_library, u8_to_f32

__all__ = ["IngestRing", "available", "load_library", "u8_to_f32"]
