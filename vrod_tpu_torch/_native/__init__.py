"""The native host runtime (C++ WAL and slot allocator), built on first use
into ``_native/build/`` (see ``build.py``)."""
