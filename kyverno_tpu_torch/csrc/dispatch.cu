// The admission dispatch's host side: no kernel of its own. It replaces
// no TPU kernel either; it is how K6 (the JAX package's donated
// stable-shape dispatch, its ops/eval.py:926 with models/engine.py:232-263)
// and the plain route reach the card in one call each.
//
// Why: an admission flush runs beside up to 16 threads that evaluate the
// oracle in Python. Every foreign call that gives up the interpreter lock
// must win it back from them, and each retake waits for a share of the
// lock's 5 ms switch interval; a dispatch of a dozen such calls took
// seconds on an H100 host (PERF.md, PR 17). These entries are bound with
// ctypes.PyDLL, which keeps the lock through the call, and each does a
// dispatch's card work in one call:
//
//   K6    the slot's card work (H2D, K1, eval_rules, D2H over its own
//         buffers) is captured once as a CUDA graph (ktpu_capture_begin,
//         then the wrappers and ktpu_copy on the capturing stream, then
//         ktpu_capture_end); a warm dispatch is ktpu_replay: the blob into
//         the slot's pinned staging, the graph, the slot's event.
//   plain ktpu_dispatch: the blob from pageable memory into a fresh device
//         buffer, then K1 and eval_rules through their own entries (their
//         addresses and argument arrays come from the caller), all on the
//         caller's stream.
//
// Every entry returns a cudaError_t (0 on success) or the error a kernel
// entry returned; nothing here synchronizes.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// K1's ktpu_glob_nfa and eval_rules' ktpu_eval_rules both take 12 int64s
typedef int (*Entry12)(int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                       int64_t, int64_t, int64_t, int64_t, int64_t, int64_t);

int call12(int64_t entry, int64_t args) {
  const int64_t* a = (const int64_t*)args;
  return ((Entry12)entry)(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7],
                          a[8], a[9], a[10], a[11]);
}

}  // namespace

// Begin capturing `stream` in thread-local mode: other threads keep using
// the card; this thread may make no call that could synchronize.
extern "C" int ktpu_capture_begin(int64_t stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream,
                                     cudaStreamCaptureModeThreadLocal);
}

// End the capture of `stream` and instantiate it; the executable graph's
// handle goes to *exec_out. A capture that the work inside invalidated
// fails here.
extern "C" int ktpu_capture_end(int64_t stream, int64_t exec_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &graph);
  if (err != cudaSuccess) return (int)err;
  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return (int)err;
  *(int64_t*)exec_out = (int64_t)exec;
  return 0;
}

extern "C" int ktpu_graph_destroy(int64_t exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// An asynchronous copy of `bytes` on `stream`, either way (unified
// addressing names the side). From or to pageable host memory it returns
// once the host side is done with.
extern "C" int ktpu_copy(int64_t dst, int64_t src, int64_t bytes,
                         int64_t stream) {
  return (int)cudaMemcpyAsync((void*)dst, (const void*)src, (size_t)bytes,
                              cudaMemcpyDefault, (cudaStream_t)stream);
}

// K6's warm dispatch: `bytes` of the caller's blob into the slot's pinned
// staging, the slot's graph on `stream`, then the slot's event.
extern "C" int ktpu_replay(int64_t exec, int64_t staged, int64_t host,
                           int64_t bytes, int64_t event, int64_t stream) {
  memcpy((void*)staged, (const void*)host, (size_t)bytes);
  cudaError_t err = cudaGraphLaunch((cudaGraphExec_t)exec,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
}

// A new timing event recorded on `stream`, its handle to *out: the phase
// split's (models/engine.py::_Phases), recorded without giving up the
// interpreter lock, which torch's Event.record does.
extern "C" int ktpu_event_record(int64_t stream, int64_t out) {
  cudaEvent_t e = nullptr;
  cudaError_t err = cudaEventCreate(&e);
  if (err != cudaSuccess) return (int)err;
  *(int64_t*)out = (int64_t)e;
  return (int)cudaEventRecord(e, (cudaStream_t)stream);
}

// The milliseconds from event a to event b (a float to *out), once b has
// completed.
extern "C" int ktpu_event_ms(int64_t a, int64_t b, int64_t out) {
  cudaError_t err = cudaEventSynchronize((cudaEvent_t)b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaEventElapsedTime((float*)out, (cudaEvent_t)a,
                                   (cudaEvent_t)b);
}

extern "C" int ktpu_event_destroy(int64_t e) {
  return (int)cudaEventDestroy((cudaEvent_t)e);
}

// The plain route's dispatch: `bytes` of the caller's pageable blob into
// the device buffer `dst`, then K1 (`glob`, 0 for none) and eval_rules
// (`rules`, 0 for none), each an entry taking the 12 int64s at its
// argument array.
extern "C" int ktpu_dispatch(int64_t dst, int64_t src, int64_t bytes,
                             int64_t glob, int64_t glob_args, int64_t rules,
                             int64_t rules_args, int64_t stream) {
  cudaError_t e = cudaMemcpyAsync((void*)dst, (const void*)src,
                                  (size_t)bytes, cudaMemcpyHostToDevice,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  int err = 0;
  if (glob != 0 && (err = call12(glob, glob_args)) != 0) return err;
  if (rules != 0 && (err = call12(rules, rules_args)) != 0) return err;
  return 0;
}
