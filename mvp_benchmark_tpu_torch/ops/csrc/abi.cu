// ABI version of the kernel library: every csrc/*.cu is linked into one
// shared library, and ops/kernels.py refuses a library whose C interface
// (the extern "C" functions and their arguments) is not the one it binds.
// Bump it with any change to that interface.

extern "C" int mvp_kernels_abi_version() { return 23; }
