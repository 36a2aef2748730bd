// The H100's shared memory limits that the port's kernels plan in, kept in
// one place (kernels/m2l.py's SMEM_BLOCK and MAX_ROW_BYTES hold the same
// numbers; tests/test_torch_transfer.py checks that they agree).
#pragma once

#include <cstddef>

namespace aniso {

// dynamic shared memory a block may take: the opt-in maximum
// (cudaFuncAttributeMaxDynamicSharedMemorySize)
constexpr size_t kSmemBlock = 227 * 1024;
// a row of 27 r values of K1 and K3, at most: a block's maximum less 1 KB
// for the one-mode kernel's barriers and stages
constexpr size_t kMaxRowBytes = kSmemBlock - 1024;

}  // namespace aniso
