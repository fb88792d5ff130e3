"""Host-side native code of the port: the ctypes binding of the data
loader's C++ engine (``csrc/stito_io.cpp``), built into the port's own
build directory."""
