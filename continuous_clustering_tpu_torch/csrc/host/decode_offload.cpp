// Packet-decode offload: keeps raw-packet decoding off the ingest hot path.
//
// Native analog of the reference's RosSensorInput decode thread
// (ros/ros_sensor_input.hpp:19-60): the subscriber callback only enqueues
// the raw message into a ThreadSaveQueue; a dedicated thread pops and
// decodes.  Here the queue/pool come from runtime.hpp; one worker thread
// preserves packet order (firings must be emitted in azimuth order).
//
// Thread safety: the wrapped decoder (velodyne/ouster) is not internally
// synchronized, so both the worker's decode and the caller's poll take the
// offload's decoder mutex.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "runtime.hpp"

extern "C" {
void cct_velodyne_decode(void*, const uint8_t*, int64_t, uint64_t);
int cct_velodyne_poll(void*, int, float*, uint8_t*, uint64_t*);
void cct_ouster_decode(void*, const uint8_t*, int64_t, uint64_t);
int cct_ouster_poll(void*, int, float*, uint8_t*, uint64_t*);
}

namespace {

struct Packet {
  std::vector<uint8_t> data;
  uint64_t stamp_ns;
};

struct Offload {
  void* decoder = nullptr;
  int kind = 0;  // 0 = velodyne, 1 = ouster
  std::mutex dec_mutex;
  std::atomic<int64_t> inflight{0};
  std::mutex done_mutex;
  std::condition_variable done_cv;
  cct::ThreadPool<Packet> pool;

  void start(int num_threads) {
    pool.init(
        [this](Packet&& p) {
          {
            std::lock_guard<std::mutex> lock(dec_mutex);
            if (kind == 0)
              cct_velodyne_decode(decoder, p.data.data(),
                                  static_cast<int64_t>(p.data.size()),
                                  p.stamp_ns);
            else
              cct_ouster_decode(decoder, p.data.data(),
                                static_cast<int64_t>(p.data.size()),
                                p.stamp_ns);
          }
          if (inflight.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> l(done_mutex);
            done_cv.notify_all();
          }
        },
        num_threads);
  }
};

}  // namespace

extern "C" {

// num_threads == 0 degenerates to synchronous inline decode (the
// reference's single-threaded deterministic mode).
void* cct_offload_create(void* decoder, int kind, int num_threads) {
  auto* o = new Offload();
  o->decoder = decoder;
  o->kind = kind;
  o->start(num_threads > 1 ? 1 : num_threads);  // order requires <= 1 worker
  return o;
}

void cct_offload_destroy(void* h) { delete static_cast<Offload*>(h); }

void cct_offload_enqueue(void* h, const uint8_t* packet, int64_t size,
                         uint64_t stamp_ns) {
  auto* o = static_cast<Offload*>(h);
  Packet p;
  p.data.assign(packet, packet + size);
  p.stamp_ns = stamp_ns;
  o->inflight.fetch_add(1);
  o->pool.enqueue(std::move(p));
}

// Packets enqueued but not yet decoded (workload/queue-depth metric; the
// reference samples its insertion queue the same way).
int64_t cct_offload_pending(void* h) {
  return static_cast<Offload*>(h)->inflight.load();
}

// Block until every enqueued packet has been decoded.
void cct_offload_drain(void* h) {
  auto* o = static_cast<Offload*>(h);
  std::unique_lock<std::mutex> l(o->done_mutex);
  o->done_cv.wait(l, [&] { return o->inflight.load() == 0; });
}

// Poll the wrapped decoder under the decode mutex (signatures of the
// velodyne and ouster polls are identical).
int cct_offload_poll(void* h, int max_firings, float* xyz, uint8_t* inten,
                     uint64_t* stamps) {
  auto* o = static_cast<Offload*>(h);
  std::lock_guard<std::mutex> lock(o->dec_mutex);
  if (o->kind == 0)
    return cct_velodyne_poll(o->decoder, max_firings, xyz, inten, stamps);
  return cct_ouster_poll(o->decoder, max_firings, xyz, inten, stamps);
}
}
