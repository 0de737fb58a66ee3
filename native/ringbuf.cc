// Native host-side streaming runtime: lock-free SPSC ring buffer + chunked
// stream scheduler for complex64 sample streams.
//
// This is the framework's counterpart of the role GNU Radio's C++
// runtime plays in the reference (SURVEY.md §2.8 X1/X2: thread-per-block
// scheduler moving complex64 samples through shared-memory ring buffers,
// with the <=4095-sample work quantum and leftover carry of
// LEGACY/gr-ofdm-tx/python/OFDMTransmitter.py:92-102).  Device compute is
// jitted JAX; this library does the host side: staging sample chunks
// between producers (file loaders, sample generators) and the fixed-size
// device batches the jitted steps consume, without the GIL in the copy
// path.
//
// Build: g++ -O3 -shared -fPIC -o libofdm_ring.so ringbuf.cc -lpthread
// (driven by lte_gnu_radio_code/runtime/native.py)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer over complex64 samples (interleaved float32 I/Q).
// Single producer thread, single consumer thread, lock-free via acquire/
// release indices — the same discipline as GNU Radio's circular buffers.
// ---------------------------------------------------------------------------

struct Ring {
  float* data;                     // 2 floats per sample
  size_t capacity;                 // in samples, power of two
  size_t mask;
  std::atomic<uint64_t> head;      // write index (samples, monotonic)
  std::atomic<uint64_t> tail;      // read index  (samples, monotonic)
};

static size_t round_pow2(size_t x) {
  size_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

Ring* ring_create(size_t capacity_samples) {
  Ring* r = new (std::nothrow) Ring;
  if (!r) return nullptr;
  r->capacity = round_pow2(capacity_samples);
  r->mask = r->capacity - 1;
  r->data = new (std::nothrow) float[2 * r->capacity];
  if (!r->data) { delete r; return nullptr; }
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  return r;
}

void ring_destroy(Ring* r) {
  if (!r) return;
  delete[] r->data;
  delete r;
}

size_t ring_capacity(const Ring* r) { return r->capacity; }

size_t ring_available(const Ring* r) {  // samples readable
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

size_t ring_space(const Ring* r) {      // samples writable
  return r->capacity - ring_available(r);
}

// Write up to n samples; returns the number written (may be < n when full).
size_t ring_write(Ring* r, const float* iq, size_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t space = r->capacity - (size_t)(head - tail);
  if (n > space) n = space;
  if (n == 0) return 0;
  size_t idx = (size_t)(head & r->mask);
  size_t first = r->capacity - idx;
  if (first > n) first = n;
  std::memcpy(r->data + 2 * idx, iq, 2 * first * sizeof(float));
  if (n > first)
    std::memcpy(r->data, iq + 2 * first, 2 * (n - first) * sizeof(float));
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Read up to n samples; returns the number read (may be < n when empty).
size_t ring_read(Ring* r, float* iq, size_t n) {
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  if (n > avail) n = avail;
  if (n == 0) return 0;
  size_t idx = (size_t)(tail & r->mask);
  size_t first = r->capacity - idx;
  if (first > n) first = n;
  std::memcpy(iq, r->data + 2 * idx, 2 * first * sizeof(float));
  if (n > first)
    std::memcpy(iq + 2 * first, r->data, 2 * (n - first) * sizeof(float));
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// Peek without consuming (overlap-save halo reads).
size_t ring_peek(Ring* r, float* iq, size_t n) {
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  if (n > avail) n = avail;
  if (n == 0) return 0;
  size_t idx = (size_t)(tail & r->mask);
  size_t first = r->capacity - idx;
  if (first > n) first = n;
  std::memcpy(iq, r->data + 2 * idx, 2 * first * sizeof(float));
  if (n > first)
    std::memcpy(iq + 2 * first, r->data, 2 * (n - first) * sizeof(float));
  return n;
}

// ---------------------------------------------------------------------------
// Chunked stream scheduler: the work-quantum/leftover-carry semantics of the
// reference TX (OFDMTransmitter.py:92-102) generalised — pull from a ring in
// quanta of at most `max_quantum`, assembling exactly `chunk` samples per
// emitted batch, carrying leftovers across pump() calls.
// ---------------------------------------------------------------------------

struct Chunker {
  Ring* ring;       // not owned
  size_t chunk;     // output batch size in samples
  size_t max_quantum;
  float* stage;     // staging buffer for one chunk
  size_t staged;    // samples currently staged
};

Chunker* chunker_create(Ring* ring, size_t chunk, size_t max_quantum) {
  Chunker* c = new (std::nothrow) Chunker;
  if (!c) return nullptr;
  c->ring = ring;
  c->chunk = chunk;
  c->max_quantum = max_quantum ? max_quantum : 4095;
  c->stage = new (std::nothrow) float[2 * chunk];
  if (!c->stage) { delete c; return nullptr; }
  c->staged = 0;
  return c;
}

void chunker_destroy(Chunker* c) {
  if (!c) return;
  delete[] c->stage;
  delete c;
}

// Try to emit one full chunk into out; returns 1 if a chunk was produced,
// 0 if not enough samples are buffered yet.
int chunker_pump(Chunker* c, float* out) {
  while (c->staged < c->chunk) {
    size_t want = c->chunk - c->staged;
    if (want > c->max_quantum) want = c->max_quantum;
    size_t got = ring_read(c->ring, c->stage + 2 * c->staged, want);
    if (got == 0) return 0;
    c->staged += got;
  }
  std::memcpy(out, c->stage, 2 * c->chunk * sizeof(float));
  c->staged = 0;
  return 1;
}

size_t chunker_staged(const Chunker* c) { return c->staged; }

}  // extern "C"
