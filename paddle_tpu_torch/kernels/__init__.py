"""Hand-written CUDA kernels for Hopper, each beside its plain twin.

Sources live in `csrc/`; `_build.load_library()` compiles them with nvcc
for sm_90a at first use. Importing this package (or any module in it)
builds nothing, so the CPU can import everything.
"""
