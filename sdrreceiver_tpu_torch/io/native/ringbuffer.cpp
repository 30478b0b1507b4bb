// Native ingest runtime: lock-free-ish SPSC ring buffer + u8->f32 LUT.
//
// TPU-native equivalent of the reference's device runtime (jonti/sdr.cpp):
//   * rtlsdr_callback writes u8 IQ into one of N ring slots via a 256-entry
//     LUT (jonti/sdr.cpp:43-49,100-145), dropping the whole buffer when the
//     ring is full (jonti/sdr.cpp:104-111)
//   * demod_dispatcher blocks on a wait condition and drains slots
//     (jonti/sdr.cpp:147-184)
//
// Here the same roles: a producer thread (rtl_tcp socket reader or a local
// byte source) pushes fixed-size blocks; the Python pipeline pops converted
// float32 blocks ready for jax.device_put.  One mutex + condvar pair guards
// the slot counters exactly like the reference's QMutex/QWaitCondition
// (jonti/sdr.h:89-99); the memcpy/convert happens outside the lock.
//
// Each slot carries its push time on steady_clock (CLOCK_MONOTONIC on Linux,
// the clock of Python's time.monotonic_ns), read back after a pop as
// rb_last_push_ns; high_water is the most slots ever full at once.
//
// C API (ctypes-friendly), all functions return 0 on success unless noted.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct RingBuffer {
  int n_slots;
  int64_t block_bytes;     // size of one raw u8 block
  std::vector<uint8_t> storage;
  std::vector<int64_t> fill;  // bytes currently in each slot
  std::vector<int64_t> pushed_ns;  // each slot's push time, steady_clock ns
  int64_t last_push_ns = 0;        // push time of the last slot popped (consumer only)
  // slot state: [tail, head) full; producer writes head, consumer reads tail
  int head = 0, tail = 0, count = 0;
  std::atomic<uint64_t> pushed{0}, popped{0}, dropped{0};
  int high_water = 0;  // guarded by mu
  std::mutex mu;
  std::condition_variable cv_data, cv_space;
  bool closed = false;
  float lut[256];

  RingBuffer(int slots, int64_t bytes) : n_slots(slots), block_bytes(bytes) {
    storage.resize(static_cast<size_t>(slots) * bytes);
    fill.assign(slots, 0);
    pushed_ns.assign(slots, 0);
    // (v - 127) * 1.0 — the reference's exact LUT (jonti/sdr.cpp:43-49)
    for (int i = 0; i < 256; i++) lut[i] = static_cast<float>(i - 127);
  }
  uint8_t* slot(int i) { return storage.data() + static_cast<size_t>(i) * block_bytes; }
};

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

void* rb_create(int n_slots, int64_t block_bytes) {
  if (n_slots <= 0 || block_bytes <= 0) return nullptr;
  return new RingBuffer(n_slots, block_bytes);
}

void rb_destroy(void* h) { delete static_cast<RingBuffer*>(h); }

// Producer: copy one raw block in.  Drops (returns 1) when the ring is full,
// mirroring the reference's drop-on-full policy; blocks instead when
// block_on_full != 0.  Returns -1 if closed.
int rb_push(void* h, const uint8_t* data, int64_t n_bytes, int block_on_full) {
  auto* rb = static_cast<RingBuffer*>(h);
  if (n_bytes > rb->block_bytes) return -2;
  int slot_idx;
  {
    std::unique_lock<std::mutex> lk(rb->mu);
    if (rb->closed) return -1;
    if (rb->count == rb->n_slots) {
      if (!block_on_full) {
        rb->dropped.fetch_add(1, std::memory_order_relaxed);
        return 1;  // "Dropped RTL buffer!!" (jonti/sdr.cpp:107)
      }
      rb->cv_space.wait(lk, [&] { return rb->count < rb->n_slots || rb->closed; });
      if (rb->closed) return -1;
    }
    slot_idx = rb->head;
  }
  std::memcpy(rb->slot(slot_idx), data, static_cast<size_t>(n_bytes));
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->fill[slot_idx] = n_bytes;
    rb->pushed_ns[slot_idx] = now_ns();
    rb->head = (rb->head + 1) % rb->n_slots;
    rb->count++;
    if (rb->count > rb->high_water) rb->high_water = rb->count;
    rb->pushed.fetch_add(1, std::memory_order_relaxed);
  }
  rb->cv_data.notify_one();
  return 0;
}

// Consumer: pop one block converted u8 -> float32 via the LUT.
// timeout_ms < 0 waits forever.  Returns number of FLOATS written, 0 on
// timeout, -1 when closed and drained.
int64_t rb_pop_f32(void* h, float* out, int64_t capacity_floats, int timeout_ms) {
  auto* rb = static_cast<RingBuffer*>(h);
  int slot_idx;
  int64_t n;
  {
    std::unique_lock<std::mutex> lk(rb->mu);
    auto ready = [&] { return rb->count > 0 || rb->closed; };
    if (timeout_ms < 0) {
      rb->cv_data.wait(lk, ready);
    } else if (!rb->cv_data.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready)) {
      return 0;
    }
    if (rb->count == 0) return -1;  // closed and drained
    slot_idx = rb->tail;
    n = rb->fill[slot_idx];
    rb->last_push_ns = rb->pushed_ns[slot_idx];
  }
  if (n > capacity_floats) n = capacity_floats;
  const uint8_t* src = rb->slot(slot_idx);
  for (int64_t i = 0; i < n; i++) out[i] = rb->lut[src[i]];
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->tail = (rb->tail + 1) % rb->n_slots;
    rb->count--;
    rb->popped.fetch_add(1, std::memory_order_relaxed);
  }
  rb->cv_space.notify_one();
  return n;
}

// Raw pop without conversion (for cf32 passthrough sources).
int64_t rb_pop_raw(void* h, uint8_t* out, int64_t capacity_bytes, int timeout_ms) {
  auto* rb = static_cast<RingBuffer*>(h);
  int slot_idx;
  int64_t n;
  {
    std::unique_lock<std::mutex> lk(rb->mu);
    auto ready = [&] { return rb->count > 0 || rb->closed; };
    if (timeout_ms < 0) {
      rb->cv_data.wait(lk, ready);
    } else if (!rb->cv_data.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready)) {
      return 0;
    }
    if (rb->count == 0) return -1;
    slot_idx = rb->tail;
    n = rb->fill[slot_idx];
    rb->last_push_ns = rb->pushed_ns[slot_idx];
  }
  if (n > capacity_bytes) n = capacity_bytes;
  std::memcpy(out, rb->slot(slot_idx), static_cast<size_t>(n));
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->tail = (rb->tail + 1) % rb->n_slots;
    rb->count--;
    rb->popped.fetch_add(1, std::memory_order_relaxed);
  }
  rb->cv_space.notify_one();
  return n;
}

void rb_close(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->closed = true;
  }
  rb->cv_data.notify_all();
  rb->cv_space.notify_all();
}

uint64_t rb_stat_pushed(void* h) { return static_cast<RingBuffer*>(h)->pushed.load(); }
uint64_t rb_stat_popped(void* h) { return static_cast<RingBuffer*>(h)->popped.load(); }
uint64_t rb_stat_dropped(void* h) { return static_cast<RingBuffer*>(h)->dropped.load(); }
int rb_stat_depth(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return rb->count;
}
int rb_stat_high_water(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return rb->high_water;
}
// Push time (steady_clock ns) of the block the last successful pop returned;
// call from the consumer's thread.
int64_t rb_last_push_ns(void* h) { return static_cast<RingBuffer*>(h)->last_push_ns; }

// Standalone batch converter: u8 -> f32 with the (v-127) LUT semantics.
void u8_to_f32(const uint8_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = static_cast<float>(in[i]) - 127.0f;
}

}  // extern "C"
