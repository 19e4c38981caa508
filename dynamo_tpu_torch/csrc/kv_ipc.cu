// CUDA IPC for the cross-process device tier of disagg
// (dynamo_tpu_torch/disagg/device_transfer.py).  Not a kernel: a plain C
// interface over the runtime's interprocess memory and event handles, so
// a prefill worker and a decode worker in two processes on one card move
// a parked prefill's KV device to device.  It stands where the JAX
// package's transfer server stands (dynamo_tpu/disagg/device_transfer.py,
// jax.experimental.transfer).
//
// The sender stages each chunk in a buffer this library allocates with
// cudaMalloc: a handle then names the chunk exactly (offset 0), and the
// buffer is out of reach of PyTorch's caching allocator, whose
// expandable segments break legacy IPC.  Each staging buffer carries an
// interprocess event, recorded on the sender's stream after the copy
// into it; the receiver waits on that event on its own stream before it
// copies out.  A process opens each handle once and keeps it (opening a
// handle costs about a millisecond; a handle opens once per context).
//
// Every entry returns a cudaError_t (0 = success); the caller raises.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

extern "C" {

int kv_ipc_handle_size(void) {
    static_assert(sizeof(cudaIpcMemHandle_t) == sizeof(cudaIpcEventHandle_t),
                  "one handle size for memory and events");
    return (int)sizeof(cudaIpcMemHandle_t);
}

const char* kv_ipc_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}

int kv_ipc_device_uuid(int device, unsigned char* out16) {
    cudaDeviceProp prop;
    cudaError_t err = cudaGetDeviceProperties(&prop, device);
    if (err != cudaSuccess) return err;
    std::memcpy(out16, prop.uuid.bytes, 16);
    return cudaSuccess;
}

int kv_ipc_malloc(int device, size_t bytes, void** ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaMalloc(ptr, bytes);
}

int kv_ipc_free(int device, void* ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaFree(ptr);
}

int kv_ipc_mem_handle(void* ptr, void* out) {
    cudaIpcMemHandle_t h;
    cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
    if (err != cudaSuccess) return err;
    std::memcpy(out, &h, sizeof(h));
    return cudaSuccess;
}

int kv_ipc_open_mem(int device, const void* handle, void** ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaIpcMemHandle_t h;
    std::memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int kv_ipc_close_mem(int device, void* ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaIpcCloseMemHandle(ptr);
}

int kv_ipc_event_create(int device, void** ev) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaEventCreateWithFlags(
        reinterpret_cast<cudaEvent_t*>(ev),
        cudaEventInterprocess | cudaEventDisableTiming);
}

int kv_ipc_event_handle(void* ev, void* out) {
    cudaIpcEventHandle_t h;
    cudaError_t err = cudaIpcGetEventHandle(&h, (cudaEvent_t)ev);
    if (err != cudaSuccess) return err;
    std::memcpy(out, &h, sizeof(h));
    return cudaSuccess;
}

int kv_ipc_open_event(int device, const void* handle, void** ev) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaIpcEventHandle_t h;
    std::memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenEventHandle(reinterpret_cast<cudaEvent_t*>(ev), h);
}

int kv_ipc_event_destroy(void* ev) {
    return cudaEventDestroy((cudaEvent_t)ev);
}

// Sender: copy `bytes` from src to dst on `stream` of `device` (enqueued,
// no wait; stream 0 is that device's default stream).
int kv_ipc_copy(int device, void* dst, const void* src, size_t bytes,
                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                           (cudaStream_t)stream);
}

// Sender: record the staging buffer's event after the copies into it.
int kv_ipc_record(int device, void* ev, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaEventRecord((cudaEvent_t)ev, (cudaStream_t)stream);
}

// Receiver: on `stream`, wait for the sender's event, copy `bytes` from
// the opened buffer into dst, and block until the copy has landed.
// *wait_ms and *copy_ms are the device's times for the two (timing
// events around the wait and the copy).
int kv_ipc_fetch(int device, void* dst, const void* src, size_t bytes,
                 void* ipc_event, void* stream, float* wait_ms,
                 float* copy_ms) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = (cudaStream_t)stream;
    cudaEvent_t t[3] = {nullptr, nullptr, nullptr};
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
        err = cudaEventCreate(&t[i]);
    if (err == cudaSuccess) err = cudaEventRecord(t[0], s);
    if (err == cudaSuccess)
        err = cudaStreamWaitEvent(s, (cudaEvent_t)ipc_event, 0);
    if (err == cudaSuccess) err = cudaEventRecord(t[1], s);
    if (err == cudaSuccess)
        err = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess) err = cudaEventRecord(t[2], s);
    if (err == cudaSuccess) err = cudaEventSynchronize(t[2]);
    if (err == cudaSuccess) err = cudaEventElapsedTime(wait_ms, t[0], t[1]);
    if (err == cudaSuccess) err = cudaEventElapsedTime(copy_ms, t[1], t[2]);
    for (int i = 0; i < 3; ++i)
        if (t[i] != nullptr) cudaEventDestroy(t[i]);
    return err;
}

// The availability probe's two ends.  Owner: fill a fresh buffer with
// `value` and record its event.  Peer (another process): open both
// handles, wait for the event, overwrite the buffer with `value` + 1,
// wait for it, close.  The owner then reads the buffer back.
int kv_ipc_fill(int device, void* ptr, int value, size_t bytes, void* ev) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = cudaMemset(ptr, value, bytes);
    if (err == cudaSuccess) err = cudaEventRecord((cudaEvent_t)ev, 0);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    return err;
}

int kv_ipc_probe_peer(int device, const void* mem_handle,
                      const void* event_handle, int value, size_t bytes) {
    void* ptr = nullptr;
    void* ev = nullptr;
    cudaError_t err = (cudaError_t)kv_ipc_open_mem(device, mem_handle, &ptr);
    if (err == cudaSuccess)
        err = (cudaError_t)kv_ipc_open_event(device, event_handle, &ev);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(0, (cudaEvent_t)ev, 0);
    if (err == cudaSuccess) err = cudaMemsetAsync(ptr, value + 1, bytes, 0);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (ev != nullptr) cudaEventDestroy((cudaEvent_t)ev);
    if (ptr != nullptr) {
        cudaError_t c = cudaIpcCloseMemHandle(ptr);
        if (err == cudaSuccess) err = c;
    }
    return err;
}

int kv_ipc_read(int device, void* host, const void* ptr, size_t bytes) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return cudaMemcpy(host, ptr, bytes, cudaMemcpyDeviceToHost);
}

}  // extern "C"
