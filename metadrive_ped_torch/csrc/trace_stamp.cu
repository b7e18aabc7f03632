// A stage stamp of the port's tracer (core/trace.py): one thread writes
// (code, %globaltimer) into the next slot of a ring buffer in device memory.
//
// A stamp is a kernel of its own, so that it lands in a captured CUDA
// graph between the kernels of two stages and runs at every replay, where
// a host-side marker (torch.profiler.record_function) is gone. The slot is
// an atomicAdd on a 64-bit head counter, taken modulo the ring's capacity,
// so stamps of several streams of one device never share a slot; the head
// keeps counting past the capacity, so the reader knows how many were
// overwritten. %globaltimer is the device's nanosecond clock; the tracer
// maps it onto the host's time.perf_counter_ns with a calibration pair.
#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp(unsigned long long* ring, unsigned long long* head,
                            unsigned long long capacity, unsigned long long code) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(head, 1ULL) % capacity;
  ring[2 * slot] = code;
  ring[2 * slot + 1] = now;
}

}  // namespace

// Launches one stamp on `stream`; returns the launch's cudaError_t
// (0 = success). ring [capacity, 2] and head [1] are int64 on the current
// device.
extern "C" int trace_stamp_launch(void* ring, void* head, unsigned long long capacity,
                                  unsigned long long code, void* stream) {
  trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), static_cast<unsigned long long*>(head), capacity,
      code);
  return static_cast<int>(cudaGetLastError());
}
