// Native host-side message transport: framed non-blocking point-to-point
// messaging between a coordinator and n worker processes over Unix-domain
// sockets, driven by an epoll progress thread.
//
// This is the framework's analog of the reference's one native component:
// libmpi reached through MPI.jl (SURVEY component C8 — the reference's
// entire transport is MPI_Isend/Irecv/Test/Waitany/Waitall, see
// src/MPIAsyncPools.jl:99,113,137-138,161,171,182-183,212). The mapping:
//
//   MPI primitive        here
//   -----------------    ------------------------------------------------
//   MPI_Isend            coord_isend: copy payload into a per-peer send
//                        queue (the snapshot discipline of reference
//                        src/MPIAsyncPools.jl:130 lives in the transport),
//                        kick the progress thread via eventfd, return
//                        immediately.
//   progress engine      one epoll thread handling partial reads/writes on
//                        every peer socket (libmpi's progress engine).
//   MPI_Test             coord_poll/coord_take: non-blocking completion
//                        probe + payload harvest.
//   MPI_Waitany          coord_waitany: condvar sleep until any peer in a
//                        caller-supplied set has a completed inbound frame
//                        (or died), with optional timeout.
//   dead rank            peer HUP/EOF marks the rank dead (sticky); polls
//                        on a dead rank surface a death marker instead of
//                        hanging the way a dead rank hangs MPI_Waitall
//                        (SURVEY §5 'Failure detection').
//
// Wire format, both directions: a 40-byte header of five little-endian
// int64s {payload_len, seq, epoch, tag, kind} followed by payload_len raw
// bytes. kind: 0=data, 1=control/shutdown, 2=hello (worker->coordinator,
// seq carries the rank), 3=death marker (synthesized locally, never on
// the wire), 4=worker-error (payload is a serialized exception).
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/time.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

struct Header {
  int64_t len;
  int64_t seq;
  int64_t epoch;
  int64_t tag;
  int64_t kind;
};
static_assert(sizeof(Header) == 40, "header must be 5 packed int64s");

constexpr int64_t KIND_DATA = 0;
constexpr int64_t KIND_CONTROL = 1;
constexpr int64_t KIND_HELLO = 2;
constexpr int64_t KIND_DEATH = 3;
constexpr int64_t KIND_ERROR = 4;
// Same-host zero-copy broadcast: the frame's wire payload is
// [int64 shm_id, int64 body_len, codec prefix...] and the BODY lives in
// a memfd region mapped by both sides; the memfd crosses the socket as
// SCM_RIGHTS ancillary data attached to the frame's first byte. The
// receiving transport resolves the region and presents the frame as
// KIND_DATA with an out-of-band body view.
constexpr int64_t KIND_SHM = 5;

struct Frame {
  Header hdr;
  std::vector<uint8_t> payload;  // inbound frames / simple sends
  // Outbound zero-copy path: an optional codec prefix written after the
  // header, and an optional SHARED body — the pool broadcasts one
  // payload to every worker per epoch, so the snapshot is taken once
  // and the n send queues hold references, not copies.
  std::vector<uint8_t> prefix;
  std::shared_ptr<std::vector<uint8_t>> shared;
  // fd to pass via SCM_RIGHTS with the frame's first byte (shm frames);
  // owned by the frame until attached (or the frame is destroyed)
  int pass_fd = -1;

  Frame() = default;
  Frame(const Frame&) = delete;
  Frame& operator=(const Frame&) = delete;
  Frame(Frame&& o) noexcept
      : hdr(o.hdr), payload(std::move(o.payload)),
        prefix(std::move(o.prefix)), shared(std::move(o.shared)),
        pass_fd(o.pass_fd) {
    o.pass_fd = -1;
  }
  Frame& operator=(Frame&& o) noexcept {
    if (this != &o) {
      if (pass_fd >= 0) ::close(pass_fd);
      hdr = o.hdr;
      payload = std::move(o.payload);
      prefix = std::move(o.prefix);
      shared = std::move(o.shared);
      pass_fd = o.pass_fd;
      o.pass_fd = -1;
    }
    return *this;
  }
  ~Frame() {
    if (pass_fd >= 0) ::close(pass_fd);
  }

  size_t body_size() const {
    return shared ? shared->size() : payload.size();
  }
  const uint8_t* body_data() const {
    return shared ? shared->data() : payload.data();
  }
};

// A coordinator-side shared-memory broadcast payload: one memfd, one
// memcpy, any number of per-worker frames referencing it by id.
struct ShmPayload {
  int fd = -1;
  void* addr = nullptr;
  size_t len = 0;
  int64_t id = 0;
  ~ShmPayload() {
    if (addr) ::munmap(addr, len);
    if (fd >= 0) ::close(fd);
  }
};

// Blocking full read/write on a (blocking-mode) fd. Used worker-side and
// during the coordinator's hello handshake.
// Address forms: a filesystem path (Unix-domain socket, single host) or
// "tcp://host:port" (TCP with TCP_NODELAY, multi-host). Port 0 binds an
// ephemeral port readable via msgt_coord_port. Returns 0 = not a tcp://
// address, 1 = parsed, -1 = malformed (tcp:// prefix but bad host/port
// — a hard error, NOT a fallback to a unix path named "tcp://...").
int parse_tcp(const char* addr, std::string* host, int* port) {
  const char* kPrefix = "tcp://";
  if (std::strncmp(addr, kPrefix, 6) != 0) return 0;
  const char* rest = addr + 6;
  const char* colon = std::strrchr(rest, ':');
  if (!colon || colon == rest || colon[1] == '\0') return -1;
  for (const char* p = colon + 1; *p; p++)
    if (*p < '0' || *p > '9') return -1;  // "5O55" must not atoi to 0
  long pt = std::atol(colon + 1);
  if (pt < 0 || pt > 65535) return -1;
  *host = std::string(rest, colon - rest);
  *port = static_cast<int>(pt);
  return 1;
}

void tune_tcp(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Large socket buffers: the pool ships multi-MiB coded shards, and the
// default ~208 KiB buffers force a wakeup/context-switch per fraction of
// a frame. SO_*BUFFORCE (root) ignores wmem_max/rmem_max caps; the
// plain options are the unprivileged fallback. Best effort by design.
void tune_bufs(int fd) {
  int sz = 8 * 1024 * 1024;
#ifdef SO_SNDBUFFORCE
  if (setsockopt(fd, SOL_SOCKET, SO_SNDBUFFORCE, &sz, sizeof(sz)) != 0)
#endif
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
#ifdef SO_RCVBUFFORCE
  if (setsockopt(fd, SOL_SOCKET, SO_RCVBUFFORCE, &sz, sizeof(sz)) != 0)
#endif
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

bool read_full(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r == 0) return false;  // EOF
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void set_nonblocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

// ---------------------------------------------------------------- auth
// Shared-secret hello authentication (challenge-response, HMAC-SHA256 —
// the multiprocessing-authkey pattern). Without it, any process that can
// reach the listen socket can complete a hello and feed frames to the
// coordinator's deserializer. The secret itself never crosses the wire:
// the coordinator sends a random challenge, the worker proves knowledge
// of the key by returning HMAC(key, challenge). SHA-256 per FIPS 180-4;
// implemented inline because this image links no crypto library.

struct Sha256 {
  uint32_t h[8];
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
        0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
        0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
        0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
        0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
        0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
        0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
        0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (buflen > 0) {
      size_t take = 64 - buflen < n ? 64 - buflen : n;
      std::memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
    while (n >= 64) {
      block(p);
      p += 64;
      n -= 64;
    }
    if (n > 0) {
      std::memcpy(buf, p, n);
      buflen = n;
    }
  }

  void digest(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    // bypass `total` accounting for the length field itself
    std::memcpy(buf + 56, lenb, 8);
    block(buf);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void hmac_sha256(const uint8_t* key, size_t keylen, const uint8_t* msg,
                 size_t msglen, uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (keylen > 64) {
    Sha256 kh;
    kh.update(key, keylen);
    kh.digest(k);
  } else {
    std::memcpy(k, key, keylen);
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 hi;
  hi.update(ipad, 64);
  hi.update(msg, msglen);
  hi.digest(inner);
  Sha256 ho;
  ho.update(opad, 64);
  ho.update(inner, 32);
  ho.digest(out);
}

bool fill_random(uint8_t* buf, size_t n) {
  // getrandom(2) first: no fd needed, works in empty containers and
  // cannot be starved by a chroot without /dev (a clock-
  // seeded fallback makes challenges predictable, enabling MAC replay
  // — when no strong entropy exists the HANDSHAKE must fail, not
  // degrade; callers with a token configured treat false as fatal)
  size_t got = 0;
  while (got < n) {
    long r = ::syscall(SYS_getrandom, buf + got, n - got, 0);
    if (r > 0) {
      got += static_cast<size_t>(r);
      continue;
    }
    if (r < 0 && errno == EINTR) continue;
    break;  // ENOSYS (pre-3.17 kernel) or other failure: try urandom
  }
  if (got == n) return true;
  int fd = ::open("/dev/urandom", O_RDONLY | O_CLOEXEC);
  if (fd >= 0) {
    bool ok = read_full(fd, buf, n);
    ::close(fd);
    if (ok) return true;
  }
  return false;
}

constexpr size_t kChallengeLen = 16;
constexpr size_t kMacLen = 32;

// Direction tags for the mutual handshake's domain separation: the
// worker proves HMAC(token, 0x01||C), the coordinator proves
// HMAC(token, 0x02||W) — a transcript from one direction can never be
// replayed as the other's proof.
constexpr uint8_t kTagWorkerProof = 0x01;
constexpr uint8_t kTagCoordProof = 0x02;

void hmac_tagged(const std::string& token, uint8_t tag,
                 const uint8_t* challenge, size_t len, uint8_t out[32]) {
  uint8_t buf[1 + kChallengeLen];
  buf[0] = tag;
  std::memcpy(buf + 1, challenge, len);
  hmac_sha256(reinterpret_cast<const uint8_t*>(token.data()),
              token.size(), buf, 1 + len, out);
}

// Per-peer connection state owned by the progress thread.
struct Peer {
  int fd = -1;
  bool dead = false;

  // SCM_RIGHTS fds received from this worker (result-ring regions —
  // the worker passes each ring's memfd once, attached to the ring's
  // first control frame). Captured by the progress thread during
  // pump_read, consumed by the caller thread via msgt_coord_take_fd;
  // guarded by the coordinator mutex.
  std::deque<int> in_fds;

  // inbound reassembly state machine
  Header rhdr{};
  size_t rgot = 0;       // bytes of header received so far
  bool rin_payload = false;
  std::vector<uint8_t> rbuf;
  size_t rpayload_got = 0;

  // outbound queue: frames waiting to be written, partial-write cursor
  std::deque<Frame> sendq;
  size_t sent = 0;  // bytes of sendq.front() already written (hdr+payload)
};

struct Coordinator {
  int n = 0;
  int listen_fd = -1;
  int epfd = -1;
  int wake_fd = -1;  // eventfd: kicks the progress thread for sends/stop
  bool tcp = false;
  int port = 0;      // bound TCP port (after create), 0 for unix
  std::string path;  // unix socket path to unlink, empty for tcp
  std::thread progress;
  std::atomic<bool> stopping{false};

  std::string token;  // shared secret; empty = no authentication

  std::mutex mu;                   // guards peers' queues + completed
  std::condition_variable cv;      // notified on arrival / death
  std::vector<Peer> peers;
  std::vector<int> parked;  // authenticated reconnects awaiting reaccept
  std::vector<std::deque<Frame>> completed;  // inbound frames per rank
  std::string error;  // first fatal progress-engine error, for diagnostics

  ~Coordinator() {
    if (listen_fd >= 0) ::close(listen_fd);
    if (epfd >= 0) ::close(epfd);
    if (wake_fd >= 0) ::close(wake_fd);
    for (auto& p : peers) {
      if (p.fd >= 0) ::close(p.fd);
      for (int fd : p.in_fds) ::close(fd);
    }
    for (int fd : parked)
      if (fd >= 0) ::close(fd);
    if (!path.empty()) ::unlink(path.c_str());
  }
};

// Total outbound bytes of a frame (header + prefix + body); the
// partial-write cursor is a single offset over that concatenation.
size_t frame_bytes(const Frame& f) {
  return sizeof(Header) + f.prefix.size() + f.body_size();
}

// Map the partial-write offset to (segment pointer, bytes available):
// the frame is written as header, then prefix, then body, without ever
// materializing the concatenation.
const uint8_t* frame_segment(const Frame& f, size_t off, size_t* avail) {
  if (off < sizeof(Header)) {
    *avail = sizeof(Header) - off;
    return reinterpret_cast<const uint8_t*>(&f.hdr) + off;
  }
  off -= sizeof(Header);
  if (off < f.prefix.size()) {
    *avail = f.prefix.size() - off;
    return f.prefix.data() + off;
  }
  off -= f.prefix.size();
  *avail = f.body_size() - off;
  return f.body_data() + off;
}

void mark_dead(Coordinator* c, int rank) {
  // caller holds c->mu
  Peer& p = c->peers[rank];
  if (p.dead) return;
  p.dead = true;
  if (p.fd >= 0) {
    epoll_ctl(c->epfd, EPOLL_CTL_DEL, p.fd, nullptr);
    ::close(p.fd);
    p.fd = -1;
  }
  p.sendq.clear();
  for (int fd : p.in_fds) ::close(fd);
  p.in_fds.clear();
  c->cv.notify_all();
}

// recvmsg wrapper for the coordinator's inbound pump: any SCM_RIGHTS
// fds riding the stream (worker result-ring announcements) are queued
// per peer instead of silently discarded. Same return contract as
// ::read.
ssize_t coord_recv(Coordinator* c, int rank, void* buf, size_t n) {
  Peer& p = c->peers[rank];
  msghdr mh{};
  iovec iov{buf, n};
  mh.msg_iov = &iov;
  mh.msg_iovlen = 1;
  alignas(cmsghdr) char cbuf[CMSG_SPACE(4 * sizeof(int))];
  mh.msg_control = cbuf;
  mh.msg_controllen = sizeof(cbuf);
  ssize_t r = ::recvmsg(p.fd, &mh, MSG_CMSG_CLOEXEC);
  if (r > 0) {
    for (cmsghdr* cm = CMSG_FIRSTHDR(&mh); cm != nullptr;
         cm = CMSG_NXTHDR(&mh, cm)) {
      if (cm->cmsg_level == SOL_SOCKET && cm->cmsg_type == SCM_RIGHTS) {
        size_t nfds = (cm->cmsg_len - CMSG_LEN(0)) / sizeof(int);
        int fds[4];
        size_t take = nfds < size_t(4) ? nfds : size_t(4);
        std::memcpy(fds, CMSG_DATA(cm), take * sizeof(int));
        std::lock_guard<std::mutex> lk(c->mu);
        for (size_t i = 0; i < take; i++) p.in_fds.push_back(fds[i]);
      }
    }
  }
  return r;
}

// Drain as many inbound bytes as available on peer `rank`; push completed
// frames. Returns false if the peer died.
bool pump_read(Coordinator* c, int rank) {
  Peer& p = c->peers[rank];
  while (true) {
    if (!p.rin_payload) {
      auto* dst = reinterpret_cast<uint8_t*>(&p.rhdr) + p.rgot;
      ssize_t r = coord_recv(c, rank, dst, sizeof(Header) - p.rgot);
      if (r == 0) return false;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
      }
      p.rgot += static_cast<size_t>(r);
      if (p.rgot < sizeof(Header)) continue;
      if (p.rhdr.len < 0) return false;  // corrupt frame
      p.rin_payload = true;
      p.rbuf.resize(static_cast<size_t>(p.rhdr.len));
      p.rpayload_got = 0;
    }
    while (p.rpayload_got < p.rbuf.size()) {
      ssize_t r = coord_recv(c, rank, p.rbuf.data() + p.rpayload_got,
                             p.rbuf.size() - p.rpayload_got);
      if (r == 0) return false;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
      }
      p.rpayload_got += static_cast<size_t>(r);
    }
    {
      std::lock_guard<std::mutex> lk(c->mu);
      Frame f;
      f.hdr = p.rhdr;
      f.payload = std::move(p.rbuf);
      c->completed[rank].push_back(std::move(f));
      c->cv.notify_all();
    }
    p.rbuf = {};
    p.rgot = 0;
    p.rin_payload = false;
  }
}

// Write as much of the send queue as the socket accepts. Returns false on
// a fatal write error (peer treated as dead).
bool pump_write(Coordinator* c, int rank) {
  Peer& p = c->peers[rank];
  while (true) {
    Frame* f;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      if (p.sendq.empty()) break;
      f = &p.sendq.front();
    }
    size_t total = frame_bytes(*f);
    while (p.sent < total) {
      size_t avail;
      const uint8_t* src = frame_segment(*f, p.sent, &avail);
      ssize_t r;
      if (f->pass_fd >= 0 && p.sent == 0) {
        // attach the shm fd to the frame's first byte (SCM_RIGHTS)
        msghdr mh{};
        iovec iov{const_cast<uint8_t*>(src), avail};
        mh.msg_iov = &iov;
        mh.msg_iovlen = 1;
        alignas(cmsghdr) char cbuf[CMSG_SPACE(sizeof(int))];
        std::memset(cbuf, 0, sizeof(cbuf));
        mh.msg_control = cbuf;
        mh.msg_controllen = sizeof(cbuf);
        cmsghdr* cm = CMSG_FIRSTHDR(&mh);
        cm->cmsg_level = SOL_SOCKET;
        cm->cmsg_type = SCM_RIGHTS;
        cm->cmsg_len = CMSG_LEN(sizeof(int));
        std::memcpy(CMSG_DATA(cm), &f->pass_fd, sizeof(int));
        r = ::sendmsg(p.fd, &mh, 0);
        if (r > 0) {
          ::close(f->pass_fd);  // in flight; kernel holds its own ref
          f->pass_fd = -1;
        }
      } else {
        r = ::write(p.fd, src, avail);
      }
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
      }
      p.sent += static_cast<size_t>(r);
    }
    {
      std::lock_guard<std::mutex> lk(c->mu);
      p.sendq.pop_front();
    }
    p.sent = 0;
  }
  // nothing left to write: stop watching EPOLLOUT
  epoll_event ev{};
  ev.events = EPOLLIN | EPOLLRDHUP;
  ev.data.u32 = static_cast<uint32_t>(rank);
  epoll_ctl(c->epfd, EPOLL_CTL_MOD, p.fd, &ev);
  return true;
}

void progress_main(Coordinator* c) {
  constexpr uint32_t WAKE_TOKEN = 0xffffffffu;
  epoll_event events[64];
  while (!c->stopping.load(std::memory_order_acquire)) {
    int nev = epoll_wait(c->epfd, events, 64, 200);
    if (nev < 0) {
      if (errno == EINTR) continue;
      // fatal: the progress engine cannot continue. Mark every peer dead
      // (polls surface death markers) and wake all waiters so nothing
      // blocks forever on a condvar nobody will notify again.
      std::lock_guard<std::mutex> lk(c->mu);
      c->error = std::string("epoll_wait: ") + strerror(errno);
      for (int r = 0; r < c->n; r++) mark_dead(c, r);
      c->cv.notify_all();
      return;
    }
    // sends may have been enqueued since the last pass: arm EPOLLOUT for
    // any peer with a non-empty queue (cheap: n is small)
    bool kicked = false;
    for (int i = 0; i < nev; i++) {
      if (events[i].data.u32 == WAKE_TOKEN) {
        uint64_t tok;
        (void)!::read(c->wake_fd, &tok, sizeof(tok));
        kicked = true;
      }
    }
    if (kicked) {
      std::lock_guard<std::mutex> lk(c->mu);
      for (int r = 0; r < c->n; r++) {
        Peer& p = c->peers[r];
        if (!p.dead && p.fd >= 0 && !p.sendq.empty()) {
          epoll_event ev{};
          ev.events = EPOLLIN | EPOLLOUT | EPOLLRDHUP;
          ev.data.u32 = static_cast<uint32_t>(r);
          epoll_ctl(c->epfd, EPOLL_CTL_MOD, p.fd, &ev);
        }
      }
    }
    for (int i = 0; i < nev; i++) {
      uint32_t id = events[i].data.u32;
      if (id == WAKE_TOKEN) continue;
      int rank = static_cast<int>(id);
      Peer& p = c->peers[rank];
      {
        // peer liveness is mutated by reaccept() on the caller thread;
        // take the lock for the check so the read is ordered (a stale
        // event for a since-replaced fd then pumps the NEW nonblocking
        // fd, which just returns EAGAIN — benign)
        std::lock_guard<std::mutex> lk(c->mu);
        if (p.dead || p.fd < 0) continue;
      }
      bool ok = true;
      if (events[i].events & (EPOLLIN | EPOLLRDHUP | EPOLLHUP | EPOLLERR))
        ok = pump_read(c, rank);
      if (ok && (events[i].events & EPOLLOUT)) ok = pump_write(c, rank);
      if (!ok) {
        std::lock_guard<std::mutex> lk(c->mu);
        mark_dead(c, rank);
      }
    }
  }
}

struct WorkerCtx {
  int fd = -1;
  // shm broadcast state: fds received via SCM_RIGHTS awaiting their
  // frame. Region mapping/lifetime lives PYTHON-side (mmap objects),
  // where eviction can be refused while views are still exported —
  // a C-side munmap under a live numpy view would be a silent segfault.
  std::deque<int> pending_fds;

  ~WorkerCtx() {
    if (fd >= 0) ::close(fd);
    for (int f : pending_fds) ::close(f);
  }
};

// read_full for the worker's data phase: recvmsg so SCM_RIGHTS fds
// riding any byte land in pending_fds instead of being discarded.
bool worker_read_full(WorkerCtx* w, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    msghdr mh{};
    iovec iov{p, n};
    mh.msg_iov = &iov;
    mh.msg_iovlen = 1;
    alignas(cmsghdr) char cbuf[CMSG_SPACE(4 * sizeof(int))];
    mh.msg_control = cbuf;
    mh.msg_controllen = sizeof(cbuf);
    ssize_t r = ::recvmsg(w->fd, &mh, MSG_CMSG_CLOEXEC);
    if (r == 0) return false;  // EOF
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    for (cmsghdr* cm = CMSG_FIRSTHDR(&mh); cm != nullptr;
         cm = CMSG_NXTHDR(&mh, cm)) {
      if (cm->cmsg_level == SOL_SOCKET && cm->cmsg_type == SCM_RIGHTS) {
        size_t nfds = (cm->cmsg_len - CMSG_LEN(0)) / sizeof(int);
        int fds[4];
        std::memcpy(fds, CMSG_DATA(cm),
                    std::min(nfds, size_t(4)) * sizeof(int));
        for (size_t i = 0; i < std::min(nfds, size_t(4)); i++)
          w->pending_fds.push_back(fds[i]);
      }
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}



// Coordinator side of the hello auth exchange, run with SO_RCVTIMEO
// still armed on `fd`. Always sends an ack frame telling the worker
// whether a proof is required (len = challenge size, or 0 for open
// transports). The exchange is MUTUAL (one-way auth let a
// rogue listener that issues a fake challenge feed the worker pickled
// frames): the worker returns HMAC(token, 0x01||C) plus its own
// challenge W, and the coordinator must answer HMAC(token, 0x02||W)
// before the worker enters the data phase — the multiprocessing-
// authkey pattern, both directions.
bool verify_hello_auth(Coordinator* c, int fd) {
  if (c->token.empty()) {
    Header ack{0, 0, 0, 0, KIND_HELLO};
    return write_full(fd, &ack, sizeof(ack));
  }
  uint8_t challenge[kChallengeLen];
  if (!fill_random(challenge, sizeof(challenge)))
    return false;  // no strong entropy + token configured: fail closed
  Header ack{kChallengeLen, 0, 0, 0, KIND_HELLO};
  if (!write_full(fd, &ack, sizeof(ack))) return false;
  if (!write_full(fd, challenge, sizeof(challenge))) return false;
  Header resp{};
  if (!read_full(fd, &resp, sizeof(resp))) return false;
  if (resp.kind != KIND_HELLO ||
      resp.len != static_cast<int64_t>(kMacLen + kChallengeLen))
    return false;
  uint8_t mac[kMacLen], wchal[kChallengeLen], expect[kMacLen];
  if (!read_full(fd, mac, sizeof(mac))) return false;
  if (!read_full(fd, wchal, sizeof(wchal))) return false;
  hmac_tagged(c->token, kTagWorkerProof, challenge, kChallengeLen, expect);
  uint8_t diff = 0;  // constant-time compare
  for (size_t i = 0; i < kMacLen; i++) diff |= mac[i] ^ expect[i];
  if (diff != 0) return false;
  // prove ourselves back: the worker rejects the transport otherwise
  uint8_t proof[kMacLen];
  hmac_tagged(c->token, kTagCoordProof, wchal, kChallengeLen, proof);
  Header ph{kMacLen, 0, 0, 0, KIND_HELLO};
  if (!write_full(fd, &ph, sizeof(ph))) return false;
  return write_full(fd, proof, sizeof(proof));
}

// Accept one connection, read its hello frame, and run the auth
// exchange, all before `deadline`. `expected_rank` = -1 accepts any rank
// not yet connected; otherwise the hello must carry exactly that rank —
// authenticated reconnects from OTHER currently-dead ranks are *parked*
// (not closed) so two concurrently restarting external workers cannot
// lose each other's handshake (their reaccept() picks the parked socket
// up). On success returns the rank and stores the (still blocking-mode)
// fd in *fd_out; on timeout/failure returns -1.
int accept_hello(Coordinator* c,
                 std::chrono::steady_clock::time_point deadline,
                 int expected_rank, int* fd_out) {
  auto remaining_ms = [&]() -> int64_t {
    return std::chrono::duration_cast<std::chrono::milliseconds>(
               deadline - std::chrono::steady_clock::now())
        .count();
  };
  while (true) {
    int64_t left = remaining_ms();
    if (left <= 0) return -1;
    pollfd pfd{c->listen_fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(left));
    if (pr <= 0) return -1;
    int fd = ::accept(c->listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    if (c->tcp) tune_tcp(fd);
    tune_bufs(fd);
    // cap the per-hello exchange at 2 s: a silent stray connection
    // (scanner, health check that sends no bytes) must burn seconds, not
    // the whole handshake deadline while real workers wait in the backlog
    left = remaining_ms();
    if (left > 2000) left = 2000;
    timeval tv{};
    tv.tv_sec = left > 0 ? left / 1000 : 0;
    tv.tv_usec = left > 0 ? (left % 1000) * 1000 : 1;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    Header hello{};
    bool ok = read_full(fd, &hello, sizeof(hello));
    bool valid = ok && hello.kind == KIND_HELLO && hello.len == 0 &&
                 hello.seq >= 0 && hello.seq < c->n;
    // the auth exchange runs under the same read timeout; an
    // unauthenticated peer never gets past this point
    if (valid) valid = verify_hello_auth(c, fd);
    timeval off{};  // back to no timeout before the caller takes over
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
    if (!valid) {
      // drop and keep waiting: on a public TCP listener a stray
      // connection (port scanner, bad secret) must not abort the
      // handshake — only the deadline ends it
      ::close(fd);
      continue;
    }
    int rank = static_cast<int>(hello.seq);
    if (expected_rank >= 0 && rank != expected_rank) {
      // someone else's reconnect. If that rank is currently dead this is
      // a legitimate concurrent restart: park the authenticated socket
      // for its own reaccept() call instead of dropping it.
      bool parked = false;
      {
        std::lock_guard<std::mutex> lk(c->mu);
        if (c->peers[rank].dead) {
          if (c->parked[rank] >= 0) ::close(c->parked[rank]);
          c->parked[rank] = fd;
          parked = true;
        }
      }
      if (!parked) ::close(fd);
      continue;
    }
    if (expected_rank < 0 && c->peers[rank].fd >= 0) {
      ::close(fd);  // duplicate rank during initial handshake
      continue;
    }
    *fd_out = fd;
    return rank;
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- coordinator

// Create the coordinator: bind + listen at `addr` — a Unix-socket path,
// or "tcp://host:port" for multi-host (port 0 = ephemeral; read it back
// with msgt_coord_port). `token`/`token_len` install a shared secret:
// every hello must then prove knowledge of it via challenge-response
// (HMAC-SHA256) before the rank is admitted; pass token_len = 0 for an
// unauthenticated transport (trusted-network deployments only).
// Returns an opaque handle, or nullptr on failure.
void* msgt_coord_create(const char* addr_str, int n_workers,
                        const uint8_t* token, int token_len) {
  auto* c = new Coordinator();
  c->n = n_workers;
  c->peers = std::vector<Peer>(n_workers);  // in-place default
  // construction: Frame is move-only, so resize's
  // move-if-noexcept fallback to copying Peers cannot compile
  c->parked.assign(n_workers, -1);
  c->completed.resize(n_workers);
  if (token != nullptr && token_len > 0)
    c->token.assign(reinterpret_cast<const char*>(token),
                    static_cast<size_t>(token_len));
  std::string host;
  int port = 0;
  int ptcp = parse_tcp(addr_str, &host, &port);
  if (ptcp < 0) {  // malformed tcp:// — refuse, don't bind a unix path
    delete c;
    return nullptr;
  }
  if (ptcp == 1) {
    c->tcp = true;
    c->listen_fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (c->listen_fd < 0) {
      delete c;
      return nullptr;
    }
    int one = 1;
    setsockopt(c->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons(static_cast<uint16_t>(port));
    if (host.empty() || host == "0.0.0.0")
      a.sin_addr.s_addr = INADDR_ANY;
    else if (inet_pton(AF_INET, host.c_str(), &a.sin_addr) != 1) {
      delete c;
      return nullptr;
    }
    if (::bind(c->listen_fd, reinterpret_cast<sockaddr*>(&a), sizeof(a)) !=
            0 ||
        ::listen(c->listen_fd, n_workers) != 0) {
      delete c;
      return nullptr;
    }
    sockaddr_in bound{};
    socklen_t blen = sizeof(bound);
    if (getsockname(c->listen_fd, reinterpret_cast<sockaddr*>(&bound),
                    &blen) == 0)
      c->port = ntohs(bound.sin_port);
    return c;
  }
  c->path = addr_str;
  ::unlink(addr_str);
  c->listen_fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (c->listen_fd < 0) {
    delete c;
    return nullptr;
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  if (c->path.size() >= sizeof(addr.sun_path)) {
    delete c;
    return nullptr;
  }
  std::strncpy(addr.sun_path, addr_str, sizeof(addr.sun_path) - 1);
  if (::bind(c->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(c->listen_fd, n_workers) != 0) {
    delete c;
    return nullptr;
  }
  return c;
}

// Bound TCP port of the coordinator's listen socket (0 for unix sockets)
// — needed when created with port 0 (ephemeral).
int msgt_coord_port(void* h) {
  return static_cast<Coordinator*>(h)->port;
}

// Accept all n workers (each opens with a hello frame carrying its rank in
// hdr.seq), then start the progress thread. Returns 0 on success, -1 on
// timeout/handshake failure. timeout_ms bounds the WHOLE handshake (one
// shared deadline), including each hello read — a worker that connects
// but never sends its hello cannot wedge the coordinator.
int msgt_coord_accept(void* h, int64_t timeout_ms) {
  auto* c = static_cast<Coordinator*>(h);
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  for (int accepted = 0; accepted < c->n; accepted++) {
    int fd = -1;
    int rank = accept_hello(c, deadline, /*expected_rank=*/-1, &fd);
    if (rank < 0) return -1;
    set_nonblocking(fd);
    c->peers[rank].fd = fd;
  }
  c->epfd = epoll_create1(EPOLL_CLOEXEC);
  c->wake_fd = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
  if (c->epfd < 0 || c->wake_fd < 0) return -1;
  epoll_event wev{};
  wev.events = EPOLLIN;
  wev.data.u32 = 0xffffffffu;
  epoll_ctl(c->epfd, EPOLL_CTL_ADD, c->wake_fd, &wev);
  for (int r = 0; r < c->n; r++) {
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLRDHUP;
    ev.data.u32 = static_cast<uint32_t>(r);
    epoll_ctl(c->epfd, EPOLL_CTL_ADD, c->peers[r].fd, &ev);
  }
  c->progress = std::thread(progress_main, c);
  return 0;
}

// Non-blocking send: snapshot `data` into rank's send queue and kick the
// progress thread (MPI_Isend). Returns 0, or -1 if the rank is dead.
int msgt_coord_isend(void* h, int rank, int64_t seq, int64_t epoch,
                     int64_t tag, int64_t kind, const uint8_t* data,
                     int64_t len) {
  auto* c = static_cast<Coordinator*>(h);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) return -1;
    Frame f;
    f.hdr = Header{len, seq, epoch, tag, kind};
    f.payload.assign(data, data + len);
    p.sendq.push_back(std::move(f));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, sizeof(one));
  return 0;
}

// Non-blocking send with a file descriptor attached to the frame's
// first byte via SCM_RIGHTS (zero-copy transport: the
// coordinator passes a broadcast-arena memfd to each worker ONCE, on
// the first arena frame that rank sees; subsequent arena frames are
// tiny fd-less control frames). `fd` is dup'd — the caller keeps
// ownership of its copy. Unix-socket transports only (SCM_RIGHTS does
// not cross TCP; the Python layer gates on the address family).
// Returns 0 ok, -1 dead rank, -2 fd duplication failed (caller should
// fall back to a copying send).
int msgt_coord_isend_fd(void* h, int rank, int64_t seq, int64_t epoch,
                        int64_t tag, int64_t kind, const uint8_t* data,
                        int64_t len, int fd) {
  auto* c = static_cast<Coordinator*>(h);
  int dupfd = ::fcntl(fd, F_DUPFD_CLOEXEC, 0);
  if (dupfd < 0) return -2;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) {
      ::close(dupfd);
      return -1;
    }
    Frame f;
    f.hdr = Header{len, seq, epoch, tag, kind};
    f.payload.assign(data, data + len);
    f.pass_fd = dupfd;
    p.sendq.push_back(std::move(f));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, sizeof(one));
  return 0;
}

// Pop the next SCM_RIGHTS fd received from `rank` (worker result-ring
// announcements), -1 if none. Python owns the mapping and its lifetime.
int msgt_coord_take_fd(void* h, int rank) {
  auto* c = static_cast<Coordinator*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  Peer& p = c->peers[rank];
  if (p.in_fds.empty()) return -1;
  int fd = p.in_fds.front();
  p.in_fds.pop_front();
  return fd;
}

// Two-buffer non-blocking send: `pre` (a small codec header) and `body`
// are snapshotted as separate segments — the caller never concatenates,
// so a raw ndarray payload costs exactly one copy (into the queue).
int msgt_coord_isend2(void* h, int rank, int64_t seq, int64_t epoch,
                      int64_t tag, int64_t kind, const uint8_t* pre,
                      int64_t pre_len, const uint8_t* body,
                      int64_t body_len) {
  auto* c = static_cast<Coordinator*>(h);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) return -1;
    Frame f;
    f.hdr = Header{pre_len + body_len, seq, epoch, tag, kind};
    f.prefix.assign(pre, pre + pre_len);
    f.payload.assign(body, body + body_len);
    p.sendq.push_back(std::move(f));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, sizeof(one));
  return 0;
}

// ---- shared broadcast payloads -------------------------------------
// The pool broadcasts ONE payload to every idle worker per epoch
// (reference src/MPIAsyncPools.jl:118-139). A shared payload snapshots
// the bytes once; isend_shared enqueues references, so an n-worker
// broadcast is one memcpy total instead of n.

void* msgt_payload_create(const uint8_t* data, int64_t len) {
  return new std::shared_ptr<std::vector<uint8_t>>(
      std::make_shared<std::vector<uint8_t>>(data, data + len));
}

void msgt_payload_release(void* ph) {
  // frames still queued keep the underlying vector alive via their own
  // shared_ptr copies; this only drops the creator's reference
  delete static_cast<std::shared_ptr<std::vector<uint8_t>>*>(ph);
}

int msgt_coord_isend_shared(void* h, int rank, int64_t seq, int64_t epoch,
                            int64_t tag, int64_t kind, const uint8_t* pre,
                            int64_t pre_len, void* ph) {
  auto* c = static_cast<Coordinator*>(h);
  auto* sp = static_cast<std::shared_ptr<std::vector<uint8_t>>*>(ph);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) return -1;
    Frame f;
    f.hdr = Header{
        pre_len + static_cast<int64_t>((*sp)->size()), seq, epoch, tag,
        kind};
    f.prefix.assign(pre, pre + pre_len);
    f.shared = *sp;
    p.sendq.push_back(std::move(f));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, sizeof(one));
  return 0;
}

// ---- shared-memory broadcast payloads (same-host zero-copy) ---------
// One memfd holds the body; every worker maps it. An n-worker broadcast
// is ONE memcpy (into the region) + tiny descriptor frames — no payload
// bytes cross the sockets at all.

void* msgt_payload_create_shm(const uint8_t* data, int64_t len) {
  static std::atomic<int64_t> next_id{1};
  int fd = ::memfd_create("msgt-shm", MFD_CLOEXEC);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, len) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* addr = nullptr;
  if (len > 0) {
    addr = ::mmap(nullptr, static_cast<size_t>(len),
                  PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (addr == MAP_FAILED) {
      ::close(fd);
      return nullptr;
    }
    std::memcpy(addr, data, static_cast<size_t>(len));
  }
  auto* sp = new ShmPayload();
  sp->fd = fd;
  sp->addr = addr;
  sp->len = static_cast<size_t>(len);
  sp->id = next_id.fetch_add(1);
  return sp;
}

void msgt_payload_release_shm(void* ph) {
  // frames already queued carry their own dup'd fds; the region's pages
  // live until every mapping and fd is gone
  delete static_cast<ShmPayload*>(ph);
}

int msgt_coord_isend_shm(void* h, int rank, int64_t seq, int64_t epoch,
                         int64_t tag, const uint8_t* pre, int64_t pre_len,
                         void* ph) {
  auto* c = static_cast<Coordinator*>(h);
  auto* sp = static_cast<ShmPayload*>(ph);
  int dupfd = ::fcntl(sp->fd, F_DUPFD_CLOEXEC, 0);
  if (dupfd < 0) {
    // fd exhaustion is not a dead rank: degrade to an ordinary in-frame
    // copy straight out of the mapping, same wire semantics
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) return -1;
    Frame f;
    f.hdr = Header{
        pre_len + static_cast<int64_t>(sp->len), seq, epoch, tag,
        KIND_DATA};
    f.prefix.assign(pre, pre + pre_len);
    auto* base = static_cast<const uint8_t*>(sp->addr);
    f.payload.assign(base, base + sp->len);
    p.sendq.push_back(std::move(f));
    uint64_t one = 1;
    (void)!::write(c->wake_fd, &one, sizeof(one));
    return 0;
  }
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    if (p.dead) {
      ::close(dupfd);
      return -1;
    }
    Frame f;
    // wire payload: [shm_id, body_len, prefix...]; body stays in shm
    f.hdr = Header{
        static_cast<int64_t>(2 * sizeof(int64_t)) + pre_len, seq, epoch,
        tag, KIND_SHM};
    f.payload.resize(2 * sizeof(int64_t) + pre_len);
    int64_t meta[2] = {sp->id, static_cast<int64_t>(sp->len)};
    std::memcpy(f.payload.data(), meta, sizeof(meta));
    std::memcpy(f.payload.data() + sizeof(meta), pre,
                static_cast<size_t>(pre_len));
    f.pass_fd = dupfd;
    p.sendq.push_back(std::move(f));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, sizeof(one));
  return 0;
}

// Non-blocking completion probe (MPI_Test). If rank has a completed
// inbound frame, fills `hdr_out` (without consuming the payload) and
// returns 1. If the rank is dead and its queue empty, fills a death
// marker and returns 1 (sticky — a dead rank always polls ready, so no
// wait can hang on it). Otherwise returns 0.
int msgt_coord_poll(void* h, int rank, Header* hdr_out) {
  auto* c = static_cast<Coordinator*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  auto& q = c->completed[rank];
  if (!q.empty()) {
    *hdr_out = q.front().hdr;
    return 1;
  }
  if (c->peers[rank].dead) {
    *hdr_out = Header{0, -1, -1, 0, KIND_DEATH};
    return 1;
  }
  return 0;
}

// Consume the frame previously reported by msgt_coord_poll: copy its
// payload into `buf` (caller sized it from hdr.len) and pop it. Returns
// the payload length, or -1 if nothing was available.
int64_t msgt_coord_take(void* h, int rank, uint8_t* buf, int64_t bufcap) {
  auto* c = static_cast<Coordinator*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  auto& q = c->completed[rank];
  if (q.empty()) {
    // death markers are synthesized, not queued; nothing to pop
    return c->peers[rank].dead ? 0 : -1;
  }
  Frame& f = q.front();
  int64_t n = static_cast<int64_t>(f.payload.size());
  if (n > bufcap) return -1;
  std::memcpy(buf, f.payload.data(), static_cast<size_t>(n));
  q.pop_front();
  return n;
}

// Block until any rank in `ranks` has a completed frame or is dead
// (MPI_Waitany). Returns the ready rank, or -1 on timeout (-1 timeout_ms
// blocks forever).
int msgt_coord_waitany(void* h, const int32_t* ranks, int nranks,
                       int64_t timeout_ms) {
  auto* c = static_cast<Coordinator*>(h);
  std::unique_lock<std::mutex> lk(c->mu);
  auto ready = [&]() -> int {
    for (int i = 0; i < nranks; i++) {
      int r = ranks[i];
      if (!c->completed[r].empty() || c->peers[r].dead) return r;
    }
    return -1;
  };
  if (timeout_ms < 0) {
    int r;
    c->cv.wait(lk, [&] { return (r = ready()) >= 0; });
    return r;
  }
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  int r = -1;
  c->cv.wait_until(lk, deadline, [&] { return (r = ready()) >= 0; });
  return r;
}

// Re-accept a connection for a dead rank (elastic recovery: a respawned
// worker process reconnects and sends a fresh hello carrying the same
// rank). Clears the dead flag and the peer's I/O state, re-registers the
// socket with the progress engine. Frames completed by the previous
// incarnation stay queued (the layer above drops stale seqs). Returns 0
// on success, -1 on timeout / wrong-rank hello / rank not dead.
int msgt_coord_reaccept(void* h, int rank, int64_t timeout_ms) {
  auto* c = static_cast<Coordinator*>(h);
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  if (rank < 0 || rank >= c->n) return -1;
  // Tolerate a rank whose HUP the progress engine hasn't processed yet
  // (the worker process can be observed dead by the OS before the EOF is
  // drained): wait for the dead mark within the same deadline.
  while (true) {
    {
      std::lock_guard<std::mutex> lk(c->mu);
      if (c->peers[rank].dead) break;
    }
    if (std::chrono::steady_clock::now() >= deadline) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
  // an authenticated reconnect may already be parked (it arrived while a
  // DIFFERENT rank's reaccept was listening — concurrent restarts)
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    if (c->parked[rank] >= 0) {
      fd = c->parked[rank];
      c->parked[rank] = -1;
    }
  }
  if (fd < 0 && accept_hello(c, deadline, rank, &fd) != rank) return -1;
  set_nonblocking(fd);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    Peer& p = c->peers[rank];
    p.fd = fd;
    p.dead = false;
    p.rhdr = Header{};
    p.rgot = 0;
    p.rin_payload = false;
    p.rbuf = {};
    p.rpayload_got = 0;
    p.sendq.clear();
    p.sent = 0;
  }
  epoll_event ev{};
  ev.events = EPOLLIN | EPOLLRDHUP;
  ev.data.u32 = static_cast<uint32_t>(rank);
  epoll_ctl(c->epfd, EPOLL_CTL_ADD, fd, &ev);
  return 0;
}

// Copy the first fatal progress-engine error (empty string if none) into
// buf; returns its length.
int msgt_coord_error(void* h, char* buf, int cap) {
  auto* c = static_cast<Coordinator*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  int n = static_cast<int>(c->error.size());
  if (n >= cap) n = cap - 1;
  if (n > 0) std::memcpy(buf, c->error.data(), static_cast<size_t>(n));
  if (cap > 0) buf[n] = '\0';
  return n;
}

// 1 if the rank has been marked dead (EOF/HUP/write error), else 0.
int msgt_coord_is_dead(void* h, int rank) {
  auto* c = static_cast<Coordinator*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->peers[rank].dead ? 1 : 0;
}

// Stop the progress thread, close every socket, remove the socket file.
void msgt_coord_destroy(void* h) {
  auto* c = static_cast<Coordinator*>(h);
  c->stopping.store(true, std::memory_order_release);
  uint64_t one = 1;
  if (c->wake_fd >= 0) (void)!::write(c->wake_fd, &one, sizeof(one));
  if (c->progress.joinable()) c->progress.join();
  delete c;
}

// ------------------------------------------------------------------- worker

// Connect to the coordinator (Unix path or "tcp://host:port"), send the
// hello frame carrying this worker's rank, and answer the coordinator's
// auth challenge with HMAC(token, challenge) when one is issued. Returns
// an opaque handle or nullptr (bad address, connection refused, or the
// coordinator requires a secret this worker doesn't hold).
void* msgt_worker_connect(const char* addr_str, int rank,
                          const uint8_t* token, int token_len) {
  auto* w = new WorkerCtx();
  std::string host;
  int port = 0;
  int ptcp = parse_tcp(addr_str, &host, &port);
  if (ptcp < 0) {
    delete w;
    return nullptr;
  }
  if (ptcp == 1) {
    w->fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (w->fd < 0) {
      delete w;
      return nullptr;
    }
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons(static_cast<uint16_t>(port));
    const char* h = (host.empty() || host == "0.0.0.0")
                        ? "127.0.0.1"  // bound-any coordinator, same host
                        : host.c_str();
    if (inet_pton(AF_INET, h, &a.sin_addr) != 1) {
      // not an IPv4 literal: resolve the hostname
      addrinfo hints{};
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      if (getaddrinfo(h, nullptr, &hints, &res) != 0 || res == nullptr) {
        delete w;
        return nullptr;
      }
      a.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
      freeaddrinfo(res);
    }
    if (::connect(w->fd, reinterpret_cast<sockaddr*>(&a), sizeof(a)) != 0) {
      delete w;
      return nullptr;
    }
    tune_tcp(w->fd);
    tune_bufs(w->fd);
  } else {
    w->fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (w->fd < 0) {
      delete w;
      return nullptr;
    }
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, addr_str, sizeof(addr.sun_path) - 1);
    if (::connect(w->fd, reinterpret_cast<sockaddr*>(&addr),
                  sizeof(addr)) != 0) {
      delete w;
      return nullptr;
    }
    tune_bufs(w->fd);
  }
  Header hello{0, rank, 0, 0, KIND_HELLO};
  if (!write_full(w->fd, &hello, sizeof(hello))) {
    delete w;
    return nullptr;
  }
  // the coordinator always acks the hello: len == 0 means open transport,
  // len == kChallengeLen means prove knowledge of the shared secret
  Header ack{};
  if (!read_full(w->fd, &ack, sizeof(ack)) || ack.kind != KIND_HELLO) {
    delete w;
    return nullptr;
  }
  if (token_len > 0 && ack.len == 0) {
    // fail closed: this worker was configured with a secret, so an
    // "open transport" ack means the peer is NOT the coordinator we
    // were told to trust (e.g. a rogue listener that won the bind race
    // against our connect-retry loop). Downgrading would hand it
    // pickled payloads to execute.
    delete w;
    return nullptr;
  }
  if (ack.len > 0) {
    if (ack.len != static_cast<int64_t>(kChallengeLen) || token == nullptr ||
        token_len <= 0) {
      delete w;  // auth demanded but we can't answer
      return nullptr;
    }
    uint8_t challenge[kChallengeLen], mac[kMacLen];
    if (!read_full(w->fd, challenge, sizeof(challenge))) {
      delete w;
      return nullptr;
    }
    const std::string tok(reinterpret_cast<const char*>(token),
                          static_cast<size_t>(token_len));
    hmac_tagged(tok, kTagWorkerProof, challenge, sizeof(challenge), mac);
    // mutual auth: attach our own challenge and demand the
    // peer prove knowledge of the token before we unpickle anything it
    // sends — a rogue listener that merely issues a 16-byte challenge
    // must not pass. No strong entropy for W => abort, never degrade.
    uint8_t wchal[kChallengeLen];
    if (!fill_random(wchal, sizeof(wchal))) {
      delete w;
      return nullptr;
    }
    Header resp{kMacLen + kChallengeLen, rank, 0, 0, KIND_HELLO};
    if (!write_full(w->fd, &resp, sizeof(resp)) ||
        !write_full(w->fd, mac, sizeof(mac)) ||
        !write_full(w->fd, wchal, sizeof(wchal))) {
      delete w;
      return nullptr;
    }
    Header ph{};
    uint8_t proof[kMacLen], expect[kMacLen];
    if (!read_full(w->fd, &ph, sizeof(ph)) || ph.kind != KIND_HELLO ||
        ph.len != static_cast<int64_t>(kMacLen) ||
        !read_full(w->fd, proof, sizeof(proof))) {
      delete w;
      return nullptr;
    }
    hmac_tagged(tok, kTagCoordProof, wchal, sizeof(wchal), expect);
    uint8_t diff = 0;  // constant-time compare
    for (size_t i = 0; i < kMacLen; i++) diff |= proof[i] ^ expect[i];
    if (diff != 0) {
      delete w;  // peer holds the socket but not the secret
      return nullptr;
    }
  }
  return w;
}

// Standalone HMAC-SHA256 (exposed for conformance testing against a
// reference implementation; the handshake above depends on it).
void msgt_hmac_sha256(const uint8_t* key, int keylen, const uint8_t* msg,
                      int msglen, uint8_t* out32) {
  hmac_sha256(key, static_cast<size_t>(keylen), msg,
              static_cast<size_t>(msglen), out32);
}

// Blocking read of the next frame header. Returns 0 on success, -1 on
// EOF/error (coordinator gone).
int msgt_worker_recv_hdr(void* h, Header* hdr_out) {
  auto* w = static_cast<WorkerCtx*>(h);
  return worker_read_full(w, hdr_out, sizeof(Header)) ? 0 : -1;
}

// Blocking read of `len` payload bytes following a header.
int msgt_worker_recv_payload(void* h, uint8_t* buf, int64_t len) {
  auto* w = static_cast<WorkerCtx*>(h);
  return worker_read_full(w, buf, static_cast<size_t>(len)) ? 0 : -1;
}

// Pop the next SCM_RIGHTS fd received with a shm frame (-1 if none).
// The Python side owns the mapping and its lifetime (mmap module).
int msgt_worker_take_fd(void* h) {
  auto* w = static_cast<WorkerCtx*>(h);
  if (w->pending_fds.empty()) return -1;
  int fd = w->pending_fds.front();
  w->pending_fds.pop_front();
  return fd;
}

// Blocking send of one frame (header + payload).
int msgt_worker_send(void* h, int64_t seq, int64_t epoch, int64_t tag,
                     int64_t kind, const uint8_t* data, int64_t len) {
  auto* w = static_cast<WorkerCtx*>(h);
  Header hdr{len, seq, epoch, tag, kind};
  if (!write_full(w->fd, &hdr, sizeof(hdr))) return -1;
  if (len > 0 && !write_full(w->fd, data, static_cast<size_t>(len)))
    return -1;
  return 0;
}

// Two-buffer blocking send: header, codec prefix, then the body written
// straight from the caller's buffer (e.g. an ndarray's memory) — the
// worker result path is zero-copy in user space.
int msgt_worker_send2(void* h, int64_t seq, int64_t epoch, int64_t tag,
                      int64_t kind, const uint8_t* pre, int64_t pre_len,
                      const uint8_t* body, int64_t body_len) {
  auto* w = static_cast<WorkerCtx*>(h);
  Header hdr{pre_len + body_len, seq, epoch, tag, kind};
  if (!write_full(w->fd, &hdr, sizeof(hdr))) return -1;
  if (pre_len > 0 && !write_full(w->fd, pre, static_cast<size_t>(pre_len)))
    return -1;
  if (body_len > 0 &&
      !write_full(w->fd, body, static_cast<size_t>(body_len)))
    return -1;
  return 0;
}

// Blocking send of one frame with a file descriptor attached to the
// header's first byte via SCM_RIGHTS (result rings: the
// worker passes its ring memfd to the coordinator ONCE, on the ring's
// first control frame). The fd is not dup'd — the blocking send
// completes before return and the kernel holds its own reference for
// the in-flight message; the caller keeps its copy. Unix sockets only.
int msgt_worker_send_fd(void* h, int64_t seq, int64_t epoch, int64_t tag,
                        int64_t kind, const uint8_t* data, int64_t len,
                        int fd) {
  auto* w = static_cast<WorkerCtx*>(h);
  Header hdr{len, seq, epoch, tag, kind};
  const uint8_t* hp = reinterpret_cast<const uint8_t*>(&hdr);
  size_t sent = 0;
  bool fd_attached = false;
  while (sent < sizeof(hdr)) {
    ssize_t r;
    if (!fd_attached) {
      msghdr mh{};
      iovec iov{const_cast<uint8_t*>(hp + sent), sizeof(hdr) - sent};
      mh.msg_iov = &iov;
      mh.msg_iovlen = 1;
      alignas(cmsghdr) char cbuf[CMSG_SPACE(sizeof(int))];
      std::memset(cbuf, 0, sizeof(cbuf));
      mh.msg_control = cbuf;
      mh.msg_controllen = sizeof(cbuf);
      cmsghdr* cm = CMSG_FIRSTHDR(&mh);
      cm->cmsg_level = SOL_SOCKET;
      cm->cmsg_type = SCM_RIGHTS;
      cm->cmsg_len = CMSG_LEN(sizeof(int));
      std::memcpy(CMSG_DATA(cm), &fd, sizeof(int));
      r = ::sendmsg(w->fd, &mh, 0);
      if (r > 0) fd_attached = true;
    } else {
      r = ::write(w->fd, hp + sent, sizeof(hdr) - sent);
    }
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    sent += static_cast<size_t>(r);
  }
  if (len > 0 && !write_full(w->fd, data, static_cast<size_t>(len)))
    return -1;
  return 0;
}

void msgt_worker_close(void* h) {
  delete static_cast<WorkerCtx*>(h);
}

}  // extern "C"
