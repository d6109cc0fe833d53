// Launch plans, shared by every launch site of the port's kernels.
//
// A site launches through PLAN_LAUNCH(name, kernel, grid, block, smem,
// stream, args...): the grid, block and dynamic shared memory it computed
// go to cudaLaunchKernel.  Inside a query entry (`<entry>_plan`, which
// takes the entry's arguments with a record buffer in place of the stream,
// and opens a plan::Scope) the same host path runs, but every site records
// what it would launch instead: its file and line, the kernel's name, grid,
// block, dynamic shared memory, and the compiled instantiation's
// attributes (registers, static shared memory, local memory = spill
// bytes), its active blocks per SM at that block and shared memory, and
// the device's opt-in shared memory and registers per block.  So the
// launch lint (repro_torch/analysis/ir/launch_lint.py) checks the plan
// each site really launches, not a copy of its arithmetic.
//
// Record buffer: out[0] = records written; record i is out[1 + i * kFields
// ...], fields in the order of launch_lint.PLAN_FIELDS.  Host code only:
// no kernel's device code depends on this header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plan {

constexpr int kFields = 20;
constexpr int kMax = 8;

// The current thread's record buffer inside a query, else null.  One
// variable for the whole library (an inline function's static), so a query
// that crosses translation units (flash_attention_bwd's f32 half) records
// into the same buffer.
inline long long*& sink() {
  static thread_local long long* s = nullptr;
  return s;
}

struct Scope {
  long long* prev;
  explicit Scope(long long* out) : prev(sink()) {
    out[0] = 0;
    sink() = out;
  }
  ~Scope() { sink() = prev; }
};

inline cudaError_t record(long long* out, const char* file, int line, const char* name,
                          const void* fn, dim3 grid, dim3 block, size_t smem) {
  const long long n = out[0];
  if (n >= kMax) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  int active = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &active, fn, (int)(block.x * block.y * block.z), smem);
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0, regs = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&regs, cudaDevAttrMaxRegistersPerBlock, dev)) != cudaSuccess)
    return e;
  const long long v[kFields] = {line,
                                (long long)(uintptr_t)file,
                                (long long)(uintptr_t)name,
                                grid.x,
                                grid.y,
                                grid.z,
                                block.x,
                                block.y,
                                block.z,
                                (long long)smem,
                                a.numRegs,
                                (long long)a.sharedSizeBytes,
                                (long long)a.localSizeBytes,
                                a.maxThreadsPerBlock,
                                active,
                                a.maxDynamicSharedSizeBytes,
                                optin,
                                regs,
                                a.binaryVersion,
                                0};
  long long* r = out + 1 + n * kFields;
  for (int i = 0; i < kFields; ++i) r[i] = v[i];
  out[0] = n + 1;
  return cudaSuccess;
}

template <class T>
struct Id {
  using type = T;
};

// Launch `kernel` (or, inside a query, record the launch) and return the
// launch's error, as `kernel<<<grid, block, smem, stream>>>(args...);
// return cudaGetLastError();` did.  The arguments convert to the kernel's
// parameter types.
template <typename... P>
cudaError_t launch(const char* file, int line, const char* name, void (*kernel)(P...),
                   dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   typename Id<P>::type... args) {
  if (long long* out = sink())
    return record(out, file, line, name, reinterpret_cast<const void*>(kernel), grid, block,
                  smem);
  void* argv[] = {const_cast<void*>(static_cast<const void*>(&args))...};
  cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, block, argv, smem, stream);
  return cudaGetLastError();
}

}  // namespace plan

#define PLAN_LAUNCH(name, ...) plan::launch(__FILE__, __LINE__, name, __VA_ARGS__)
