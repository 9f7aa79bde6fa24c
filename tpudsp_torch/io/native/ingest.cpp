// Native IQ ingest for tpudsp_torch (a copy of the JAX package's
// tpudsp/io/native/ingest.cpp; the port builds and loads its own).
//
// The reference's only data-path native code (bytes_to_iq,
// utility.hpp:61-69) plus the streaming infrastructure the reference
// leaves to the Python radio callback (README.md:53-58): a lock-free
// single-producer/single-consumer ring buffer so a real-time radio driver
// thread can hand fixed-size IQ blocks to the runtime's pump thread
// without the GIL or allocations on the hot path.
//
// Exposed via a C ABI and loaded with ctypes (tpudsp_torch/io/ingest.py
// builds it with g++ into tpudsp_torch/_build/). The symbols keep the JAX
// package's names: ctypes loads each library RTLD_LOCAL.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// int16 interleaved IQ -> float32 interleaved (re, im), scaled by 1/32767.
// Matches the reference conversion exactly (utility.hpp:65-67).
// ---------------------------------------------------------------------------
void tpudsp_bytes_to_iq_f32(const int16_t* in, uint64_t n_pairs, float* out) {
    const float k = 1.0f / 32767.0f;
    for (uint64_t i = 0; i < 2 * n_pairs; ++i) {
        out[i] = static_cast<float>(in[i]) * k;
    }
}

// int8 variant (RTL-SDR style unsigned-offset bytes): (b - 127.5)/127.5
void tpudsp_u8_to_iq_f32(const uint8_t* in, uint64_t n_pairs, float* out) {
    const float k = 1.0f / 127.5f;
    for (uint64_t i = 0; i < 2 * n_pairs; ++i) {
        out[i] = (static_cast<float>(in[i]) - 127.5f) * k;
    }
}

// ---------------------------------------------------------------------------
// Lock-free SPSC byte ring buffer.
// ---------------------------------------------------------------------------
struct Ring {
    uint8_t* buf;
    uint64_t cap;                  // power-of-two capacity
    std::atomic<uint64_t> head;    // producer writes
    std::atomic<uint64_t> tail;    // consumer reads
    std::atomic<uint64_t> dropped; // bytes dropped on overflow
};

static uint64_t next_pow2(uint64_t v) {
    uint64_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

Ring* tpudsp_ring_create(uint64_t capacity) {
    Ring* r = new Ring();
    r->cap = next_pow2(capacity < 64 ? 64 : capacity);
    r->buf = static_cast<uint8_t*>(std::malloc(r->cap));
    r->head.store(0);
    r->tail.store(0);
    r->dropped.store(0);
    return r;
}

void tpudsp_ring_destroy(Ring* r) {
    if (!r) return;
    std::free(r->buf);
    delete r;
}

uint64_t tpudsp_ring_size(const Ring* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

uint64_t tpudsp_ring_capacity(const Ring* r) { return r->cap; }

uint64_t tpudsp_ring_dropped(const Ring* r) {
    return r->dropped.load(std::memory_order_relaxed);
}

// Producer: append n bytes; drops the WHOLE write if it does not fit
// (block-granular drop keeps IQ pairs aligned). Returns bytes written.
uint64_t tpudsp_ring_write(Ring* r, const uint8_t* src, uint64_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (r->cap - (head - tail) < n) {
        r->dropped.fetch_add(n, std::memory_order_relaxed);
        return 0;
    }
    uint64_t mask = r->cap - 1;
    uint64_t off = head & mask;
    uint64_t first = (n < r->cap - off) ? n : r->cap - off;
    std::memcpy(r->buf + off, src, first);
    std::memcpy(r->buf, src + first, n - first);
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Consumer: pop exactly n bytes; returns 0 (and copies nothing) if fewer
// are available -- callers pop fixed-size blocks for static-shape kernels.
uint64_t tpudsp_ring_read(Ring* r, uint8_t* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (head - tail < n) return 0;
    uint64_t mask = r->cap - 1;
    uint64_t off = tail & mask;
    uint64_t first = (n < r->cap - off) ? n : r->cap - off;
    std::memcpy(dst, r->buf + off, first);
    std::memcpy(dst + first, r->buf, n - first);
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

}  // extern "C"
