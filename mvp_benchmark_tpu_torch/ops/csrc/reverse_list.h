// The reverse-list kernel of reverse_list.cu, for the sources whose
// backwards gather over it instead of scattering with atomics (chamfer.cu,
// gather.cu, sa_attention.cu). See reverse_list.cu for the contract.
#pragma once

extern "C" int reverse_list_build(const int* idx, int batch, int entries, int n,
                                  int warps, int ranges, int* order, int* off,
                                  void* stream);
