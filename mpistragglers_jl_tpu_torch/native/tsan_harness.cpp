// ThreadSanitizer harness for the native transport (transport.cpp).
//
// The transport's concurrency surface — epoll progress thread vs caller
// threads (isend/poll/waitany/reaccept), worker threads doing blocking
// frame I/O, death marking under the mutex — is exactly the kind of
// code where a "benign" unlocked read becomes real UB (a review
// flagged one such race, fixed since). This harness compiles the whole
// transport with -fsanitize=thread and drives the hot paths end to end:
//
//   1. coordinator + 4 worker threads over a Unix socket, HMAC auth on;
//   2. 200 epochs of broadcast -> compute-echo -> waitany harvest, with
//      concurrent poll() probes from a second coordinator-side thread
//      (the pool's phase-1 drain running against the progress engine);
//   3. one worker killed mid-run (socket closed), death observed via the
//      sticky marker, then re-admitted through reaccept while traffic
//      continues on the survivors;
//   4. shared + shm broadcast payload paths (payload handles are
//      created/released by the caller thread while the progress thread
//      writes frames referencing them);
//   5. clean shutdown (control frames, worker exits, destroy);
//   6. ring phase: a second coordinator + 2 producer workers
//      exercising the persistent result-ring protocol end to end —
//      memfd ring announced once via SCM_RIGHTS (msgt_worker_send_fd
//      -> recvmsg capture -> msgt_coord_take_fd), concurrent
//      producer writes / consumer reads on the SAME mapped pages (the
//      producer-address read makes a protocol violation a TSAN race,
//      not just a byte mismatch), ack-frame slot reclamation, and a
//      deliberately PINNED slot whose ack is withheld while the
//      producer wraps the ring — reuse-before-ack is caught both ways.
//
// Any data race TSAN finds aborts the process non-zero
// (halt_on_error=1 is set by the pytest test); exit 0 means the run
// completed with a clean report. Built on demand by
// tests/test_tsan_transport.py; no Python in the loop — TSAN must own
// the whole address space, which it cannot do as a .so loaded into a
// non-TSAN interpreter.

#include <sys/mman.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <thread>
#include <utility>
#include <vector>

// The transport's C ABI (declared here rather than a header; the .cpp
// is compiled into this binary directly).
extern "C" {
void* msgt_coord_create(const char* addr, int n, const uint8_t* token,
                        int token_len);
int msgt_coord_accept(void* h, int64_t timeout_ms);
int msgt_coord_isend(void* h, int rank, int64_t seq, int64_t epoch,
                     int64_t tag, int64_t kind, const uint8_t* data,
                     int64_t len);
void* msgt_payload_create(const uint8_t* data, int64_t len);
void msgt_payload_release(void* ph);
int msgt_coord_isend_shared(void* h, int rank, int64_t seq, int64_t epoch,
                            int64_t tag, int64_t kind, const uint8_t* pre,
                            int64_t pre_len, void* ph);
void* msgt_payload_create_shm(const uint8_t* data, int64_t len);
void msgt_payload_release_shm(void* ph);
int msgt_coord_isend_shm(void* h, int rank, int64_t seq, int64_t epoch,
                         int64_t tag, const uint8_t* pre, int64_t pre_len,
                         void* ph);
struct Hdr {
  int64_t len, seq, epoch, tag, kind;
};
int msgt_coord_poll(void* h, int rank, Hdr* out);
int64_t msgt_coord_take(void* h, int rank, uint8_t* buf, int64_t cap);
int msgt_coord_waitany(void* h, const int32_t* ranks, int n,
                       int64_t timeout_ms);
int msgt_coord_is_dead(void* h, int rank);
int msgt_coord_reaccept(void* h, int rank, int64_t timeout_ms);
void msgt_coord_destroy(void* h);
void* msgt_worker_connect(const char* addr, int rank, const uint8_t* token,
                          int token_len);
int msgt_worker_recv_hdr(void* h, Hdr* out);
int msgt_worker_recv_payload(void* h, uint8_t* buf, int64_t len);
int msgt_worker_send(void* h, int64_t seq, int64_t epoch, int64_t tag,
                     int64_t kind, const uint8_t* data, int64_t len);
int msgt_worker_send_fd(void* h, int64_t seq, int64_t epoch, int64_t tag,
                        int64_t kind, const uint8_t* data, int64_t len,
                        int fd);
int msgt_worker_take_fd(void* h);
int msgt_coord_take_fd(void* h, int rank);
void msgt_worker_close(void* h);
}

namespace {

constexpr int64_t KIND_DATA = 0;
constexpr int64_t KIND_CONTROL = 1;
constexpr int64_t KIND_SHM = 5;
const uint8_t kToken[] = "tsan-secret";
constexpr int kTokenLen = sizeof(kToken) - 1;

void worker_main(const std::string& path, int rank, int die_after) {
  void* w = msgt_worker_connect(path.c_str(), rank, kToken, kTokenLen);
  if (!w) {
    std::fprintf(stderr, "worker %d: connect failed\n", rank);
    std::abort();
  }
  int served = 0;
  while (true) {
    Hdr hdr{};
    if (msgt_worker_recv_hdr(w, &hdr) != 0) break;
    std::vector<uint8_t> payload(hdr.len > 0 ? hdr.len : 1);
    if (hdr.len > 0 &&
        msgt_worker_recv_payload(w, payload.data(), hdr.len) != 0)
      break;
    if (hdr.kind == KIND_CONTROL) break;
    if (hdr.kind == KIND_SHM) {
      // adopt + immediately drop the region fd: the harness checks the
      // fd-passing plumbing for races, not the mapping contents
      int fd = msgt_worker_take_fd(w);
      if (fd >= 0) ::close(fd);
    }
    uint8_t echo[8];
    std::memcpy(echo, &hdr.epoch, sizeof(int64_t));
    if (msgt_worker_send(w, hdr.seq, hdr.epoch, hdr.tag, KIND_DATA, echo,
                         sizeof(echo)) != 0)
      break;
    served++;
    if (die_after > 0 && served >= die_after) break;  // simulated crash
  }
  msgt_worker_close(w);
}

constexpr int64_t KIND_RING = 7;
constexpr int64_t KIND_ACK = 8;
constexpr int kRingSlots = 4;
constexpr size_t kSlotBytes = 4096;
constexpr int kRingRounds = 40;

// Ring producer: the worker half of the result-ring protocol.
// Creates a memfd ring, publishes its base pointer for the consumer's
// same-address reads (TSAN visibility), writes each round's pattern
// into a free slot, announces the fd once (msgt_worker_send_fd on the
// first control frame), and reuses a slot only after the
// coordinator's KIND_ACK releases it — blocking on acks when all four
// slots are outstanding (the ring-full path).
void ring_worker(const std::string& path, int rank,
                 std::atomic<uint8_t*>* base_out) {
  void* w = msgt_worker_connect(path.c_str(), rank, kToken, kTokenLen);
  if (!w) {
    std::fprintf(stderr, "ring worker %d: connect failed\n", rank);
    std::abort();
  }
  int fd = ::memfd_create("tsan-ring", MFD_CLOEXEC);
  if (fd < 0 || ::ftruncate(fd, kRingSlots * kSlotBytes) != 0) std::abort();
  auto* base = static_cast<uint8_t*>(
      ::mmap(nullptr, kRingSlots * kSlotBytes, PROT_READ | PROT_WRITE,
             MAP_SHARED, fd, 0));
  if (base == MAP_FAILED) std::abort();
  base_out->store(base, std::memory_order_release);
  bool announced = false;
  bool busy[kRingSlots] = {false, false, false, false};
  auto drain_one = [&]() -> bool {  // one frame; false = shutdown/EOF
    Hdr h{};
    if (msgt_worker_recv_hdr(w, &h) != 0) return false;
    std::vector<uint8_t> p(h.len > 0 ? h.len : 1);
    if (h.len > 0 && msgt_worker_recv_payload(w, p.data(), h.len) != 0)
      return false;
    if (h.kind == KIND_CONTROL) return false;
    if (h.kind == KIND_ACK && h.len >= 24) {
      int64_t rec[3];
      std::memcpy(rec, p.data(), 24);
      if (rec[1] >= 0 && rec[1] < kRingSlots) busy[rec[1]] = false;
    }
    return true;
  };
  int64_t gen = 0;
  bool alive = true;
  for (int r = 0; alive && r < kRingRounds; r++) {
    int slot = -1;
    while (slot < 0) {
      for (int s = 0; s < kRingSlots; s++)
        if (!busy[s]) {
          slot = s;
          break;
        }
      if (slot < 0 && !(alive = drain_one())) break;  // ring full: wait
    }
    if (!alive) break;
    ++gen;
    // the write the pinned-view discipline protects: only ever into a
    // slot the consumer has acked (or never seen)
    std::memset(base + slot * kSlotBytes, static_cast<uint8_t>(gen),
                kSlotBytes);
    int64_t meta[3] = {slot, gen, static_cast<int64_t>(kSlotBytes)};
    int rc;
    if (!announced) {
      rc = msgt_worker_send_fd(w, gen, r, 0, KIND_RING,
                               reinterpret_cast<uint8_t*>(meta), 24, fd);
      announced = true;
    } else {
      rc = msgt_worker_send(w, gen, r, 0, KIND_RING,
                            reinterpret_cast<uint8_t*>(meta), 24);
    }
    if (rc != 0) break;
    busy[slot] = true;
  }
  while (alive) alive = drain_one();  // until the control broadcast
  msgt_worker_close(w);
  base_out->store(nullptr, std::memory_order_release);
  ::munmap(base, kRingSlots * kSlotBytes);
  ::close(fd);
}

// Coordinator half of the ring phase. Returns true on success.
bool run_ring_phase(const std::string& path) {
  constexpr int NR = 2;
  void* c = msgt_coord_create(path.c_str(), NR, kToken, kTokenLen);
  if (!c) return false;
  std::atomic<uint8_t*> bases[NR];
  for (auto& b : bases) b.store(nullptr);
  std::vector<std::thread> workers;
  for (int r = 0; r < NR; r++)
    workers.emplace_back(ring_worker, path, r, &bases[r]);
  bool ok = msgt_coord_accept(c, 10000) == 0;
  // concurrent prober (phase-1 discipline): non-blocking polls racing
  // the progress engine and the harvester's takes
  std::atomic<bool> stop{false};
  std::thread prober([&] {
    Hdr hdr{};
    while (!stop.load(std::memory_order_relaxed)) {
      for (int r = 0; r < NR; r++) (void)msgt_coord_poll(c, r, &hdr);
      std::this_thread::sleep_for(std::chrono::microseconds(100));
    }
  });
  uint8_t* maps[NR] = {nullptr, nullptr};
  // the deliberately pinned slot: its ack is withheld across several
  // harvests while the producer keeps wrapping the other slots
  std::deque<std::pair<int, std::array<int64_t, 3>>> pinned;
  int expect = kRingRounds * NR, got = 0;
  while (ok && got < expect) {
    int32_t ranks[NR] = {0, 1};
    int r = msgt_coord_waitany(c, ranks, NR, 10000);
    if (r < 0) {
      std::fprintf(stderr, "ring waitany timeout\n");
      ok = false;
      break;
    }
    Hdr h{};
    if (!msgt_coord_poll(c, r, &h)) continue;  // prober peeked
    uint8_t buf[64];
    if (msgt_coord_take(c, r, buf, sizeof buf) < 0) continue;
    if (h.kind == 3) {  // KIND_DEATH: a producer crashed
      std::fprintf(stderr, "ring worker %d died\n", r);
      ok = false;
      break;
    }
    if (h.kind != KIND_RING) continue;
    int64_t meta[3];
    std::memcpy(meta, buf, 24);
    if (!maps[r]) {
      int fd = msgt_coord_take_fd(c, r);
      if (fd < 0) {
        std::fprintf(stderr, "ring announce carried no fd\n");
        ok = false;
        break;
      }
      maps[r] = static_cast<uint8_t*>(::mmap(
          nullptr, kRingSlots * kSlotBytes, PROT_READ, MAP_SHARED, fd, 0));
      ::close(fd);
      if (maps[r] == MAP_FAILED) {
        ok = false;
        break;
      }
    }
    auto want = static_cast<uint8_t>(meta[1]);
    const uint8_t* slot_p = maps[r] + meta[0] * kSlotBytes;
    for (size_t k = 0; k < kSlotBytes; k += 512)
      if (slot_p[k] != want) {
        std::fprintf(stderr, "ring slot bytes torn\n");
        ok = false;
      }
    // same-address read through the PRODUCER's mapping: if the
    // protocol ever let the producer reuse this slot early, TSAN sees
    // a racing write/read pair here, not only a byte mismatch
    uint8_t* shared = bases[r].load(std::memory_order_acquire);
    if (shared && shared[meta[0] * kSlotBytes] != want) {
      std::fprintf(stderr, "ring shared view torn\n");
      ok = false;
    }
    got++;
    int64_t rec[3] = {0, meta[0], meta[1]};
    if (r == 0 && pinned.empty()) {
      // hold this slot's ack: the producer must wrap around it
      pinned.push_back({r, {rec[0], rec[1], rec[2]}});
    } else {
      msgt_coord_isend(c, r, 0, 0, 0, KIND_ACK,
                       reinterpret_cast<uint8_t*>(rec), 24);
    }
    if (!pinned.empty() && got % 8 == 0) {
      auto pr = pinned.front();
      pinned.pop_front();
      // the pinned slot must still hold ITS generation right up to the
      // release (reclaim-vs-pinned-view)
      if (maps[pr.first] &&
          maps[pr.first][pr.second[1] * kSlotBytes] !=
              static_cast<uint8_t>(pr.second[2])) {
        std::fprintf(stderr, "pinned ring slot reused before ack\n");
        ok = false;
      }
      msgt_coord_isend(c, pr.first, 0, 0, 0, KIND_ACK,
                       reinterpret_cast<uint8_t*>(pr.second.data()), 24);
    }
  }
  // release any ack still withheld so producers drain, then shut down
  for (auto& pr : pinned)
    msgt_coord_isend(c, pr.first, 0, 0, 0, KIND_ACK,
                     reinterpret_cast<uint8_t*>(pr.second.data()), 24);
  uint8_t z[1] = {0};
  for (int r = 0; r < NR; r++)
    msgt_coord_isend(c, r, 0, 0, 0, KIND_CONTROL, z, 0);
  for (auto& t : workers) t.join();
  stop.store(true);
  prober.join();
  for (auto* m : maps)
    if (m) ::munmap(m, kRingSlots * kSlotBytes);
  msgt_coord_destroy(c);
  return ok;
}

}  // namespace

int main() {
  const std::string path =
      "/tmp/msgt-tsan-" + std::to_string(::getpid()) + ".sock";
  constexpr int N = 4;
  constexpr int EPOCHS = 200;
  void* c = msgt_coord_create(path.c_str(), N, kToken, kTokenLen);
  if (!c) {
    std::fprintf(stderr, "coordinator create failed\n");
    return 2;
  }
  std::vector<std::thread> workers;
  for (int r = 0; r < N; r++)
    workers.emplace_back(worker_main, path, r, r == 1 ? 40 : 0);
  auto bail = [&](const char* why) {
    std::fprintf(stderr, "%s\n", why);
    // detach in-scope threads: destroying a joinable std::thread calls
    // std::terminate, which would replace rc=2 with SIGABRT and bury
    // the diagnostic
    for (auto& t : workers)
      if (t.joinable()) t.detach();
    std::_Exit(2);
  };
  if (msgt_coord_accept(c, 10000) != 0) bail("accept failed");

  // concurrent phase-1-style prober: non-blocking polls racing the
  // progress engine's completions (results are harvested by the main
  // loop's waitany; the prober only peeks headers)
  std::atomic<bool> stop{false};
  std::thread prober([&] {
    Hdr hdr{};
    while (!stop.load(std::memory_order_relaxed)) {
      for (int r = 0; r < N; r++) (void)msgt_coord_poll(c, r, &hdr);
      std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
  });

  int64_t seq = 0;
  bool reaccepted = false;
  uint8_t small[16] = {1};
  for (int epoch = 1; epoch <= EPOCHS; epoch++) {
    // rotate payload styles: direct, shared-buffer, shm
    int style = epoch % 3;
    void* ph = nullptr;
    for (int r = 0; r < N; r++) {
      if (msgt_coord_is_dead(c, r)) continue;
      ++seq;
      if (style == 0) {
        msgt_coord_isend(c, r, seq, epoch, 0, KIND_DATA, small,
                         sizeof(small));
      } else if (style == 1) {
        if (!ph) ph = msgt_payload_create(small, sizeof(small));
        msgt_coord_isend_shared(c, r, seq, epoch, 0, KIND_DATA, small, 4,
                                ph);
      } else {
        if (!ph) ph = msgt_payload_create_shm(small, sizeof(small));
        msgt_coord_isend_shm(c, r, seq, epoch, 0, small, 4, ph);
      }
    }
    if (ph && style == 1) msgt_payload_release(ph);
    if (ph && style == 2) msgt_payload_release_shm(ph);
    // harvest whatever the live set produces this epoch
    int32_t ranks[N];
    int live = 0;
    for (int r = 0; r < N; r++)
      if (!msgt_coord_is_dead(c, r)) ranks[live++] = r;
    int got = 0;
    while (got < live) {
      int r = msgt_coord_waitany(c, ranks, live, 5000);
      if (r < 0) bail("waitany timeout");
      Hdr hdr{};
      if (!msgt_coord_poll(c, r, &hdr)) continue;  // prober peeked; retry
      uint8_t buf[64];
      if (msgt_coord_take(c, r, buf, sizeof(buf)) < 0) continue;
      got++;  // data frame, or a death marker settling the slot
    }
    // mid-run: worker 1 died around epoch ~40; re-admit it once
    if (!reaccepted && msgt_coord_is_dead(c, 1)) {
      std::thread w(worker_main, path, 1, 0);
      if (msgt_coord_reaccept(c, 1, 10000) != 0) {
        w.detach();
        bail("reaccept failed");
      }
      w.detach();  // serves until the shutdown broadcast
      reaccepted = true;
    }
  }
  if (!reaccepted) bail("worker 1 never died/reaccepted");
  stop.store(true);
  prober.join();
  for (int r = 0; r < N; r++)
    msgt_coord_isend(c, r, 0, 0, 0, KIND_CONTROL, small, 0);
  for (auto& t : workers)
    if (t.joinable()) t.join();
  // give the detached reaccepted worker a beat to exit on the control
  // frame before the coordinator (and its socket) is destroyed
  std::this_thread::sleep_for(std::chrono::milliseconds(200));
  msgt_coord_destroy(c);
  std::printf("tsan harness: %d epochs, reaccept ok\n", EPOCHS);
  // phase 6: persistent result-ring protocol (fresh coordinator)
  const std::string ring_path =
      "/tmp/msgt-tsan-ring-" + std::to_string(::getpid()) + ".sock";
  if (!run_ring_phase(ring_path)) {
    std::fprintf(stderr, "ring phase failed\n");
    return 2;
  }
  std::printf("ring ok: %d rounds x 2 producers, pinned-slot holds\n",
              kRingRounds);
  return 0;
}
