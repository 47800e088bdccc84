// vepbus — native shared-memory frame bus of video_edge_ai_proxy_tpu_torch.
//
// The port's own copy of video_edge_ai_proxy_tpu/bus/native/vepbus.cpp. The
// ring, KV and doorbell layouts are byte-compatible with it (same magics,
// same version, same structs), so producers and consumers of either package
// can share one ring directory.
//
// Role (the reference's Redis fabric):
//   * frame data plane: one latest-wins ring per camera, replacing
//     `XADD <device_id> MAXLEN N` / `XREAD`. Ring semantics == Redis stream
//     with MAXLEN: newest frame wins, readers chase a sequence cursor.
//   * control plane: a small KV table replacing the Redis hashes/keys
//     `last_access_time_<id>` / `is_key_frame_only_<id>`.
//
// Design: single-producer (one worker per camera), multi-consumer. Each slot
// carries a seqlock (odd = write in progress). The producer publishes
// monotonically increasing sequence numbers; `head` is the latest published.
// Readers copy out the newest slot and retry if the producer lapped them.
// Memory is a file in /dev/shm mapped by every process; zero syscalls on the
// hot path, no broker process at all.
//
// C ABI only — bound from Python via ctypes (bus/shm_bus.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <ctime>
#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#endif

namespace {

constexpr uint64_t kRingMagic = 0x56455042'52494e47ULL;  // "VEPBRING"
constexpr uint64_t kKvMagic = 0x56455042'4b560001ULL;
constexpr uint64_t kDoorbellMagic = 0x56455042'44420001ULL;  // "VEPB" "DB"
constexpr uint32_t kVersion = 2;  // v2: FrameMeta grew trace_id/parent_span
constexpr size_t kKeyCap = 96;
constexpr size_t kValCap = 1024;

// Fixed-size frame metadata carried next to the pixel payload. Field set
// mirrors the reference VideoFrame proto (proto/video_streaming.proto:78-93)
// minus the raw data (which lives in the slot body).
struct FrameMeta {
  int64_t width;
  int64_t height;
  int64_t channels;
  int64_t timestamp_ms;
  int64_t pts;
  int64_t dts;
  int64_t packet;        // demuxed packet counter
  int64_t keyframe_cnt;  // keyframe counter
  int32_t is_keyframe;
  int32_t is_corrupt;
  int32_t frame_type;    // 0=?, 1=I, 2=P, 3=B
  int32_t dtype;         // 0=uint8
  double time_base;
  int64_t trace_id;      // cross-process lineage (0 = unstamped)
  int64_t parent_span;
};

struct SlotHeader {
  std::atomic<uint64_t> commit;  // seqlock; odd while being written
  uint64_t seq;                  // sequence stored in this slot
  uint64_t data_len;
  FrameMeta meta;
};

struct RingHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t slots;
  uint64_t slot_size;            // payload bytes per slot
  std::atomic<uint64_t> head;    // latest published seq (0 = none yet)
  std::atomic<uint64_t> writer_pid;
  char device_id[128];
  uint64_t reserved[8];
};

struct Ring {
  RingHeader* hdr;
  uint8_t* base;      // mapping base
  size_t map_len;
  bool writer;
};

inline size_t slot_stride(const RingHeader* h) {
  return sizeof(SlotHeader) + ((h->slot_size + 63) & ~size_t(63));
}

inline SlotHeader* slot_at(const Ring* r, uint64_t idx) {
  return reinterpret_cast<SlotHeader*>(
      r->base + sizeof(RingHeader) + idx * slot_stride(r->hdr));
}

struct KvEntry {
  std::atomic<uint64_t> commit;  // seqlock; 0 in key[0] marks empty
  char key[kKeyCap];
  uint32_t len;
  char val[kValCap];
};

struct KvHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t nslots;
  uint64_t reserved[8];
};

struct Kv {
  KvHeader* hdr;
  KvEntry* entries;
  size_t map_len;
};

// Publish doorbell: one shared 32-bit counter per bus directory. Producers
// bump it after every ring publish; a consumer assembling batches waits on
// it (Linux futex, process-shared) instead of polling the rings on a sleep
// loop — sub-100 µs wakeup with zero idle CPU (the incremental batch
// assembly path, engine/collector.py assemble_until).
struct DoorbellShm {
  uint64_t magic;
  uint32_t version;
  std::atomic<uint32_t> value;
};

struct Doorbell {
  DoorbellShm* shm;
  size_t map_len;
};

uint64_t fnv1a(const char* s) {
  uint64_t h = 1469598103934665603ULL;
  for (; *s; ++s) {
    h ^= static_cast<uint8_t>(*s);
    h *= 1099511628211ULL;
  }
  return h;
}

void* map_file(const char* path, size_t len, bool create, size_t* out_len) {
  int flags = O_RDWR | (create ? O_CREAT : 0);
  int fd = open(path, flags, 0666);
  if (fd < 0) return nullptr;
  if (create) {
    if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
      close(fd);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      close(fd);
      return nullptr;
    }
    len = static_cast<size_t>(st.st_size);
  }
  void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  *out_len = len;
  return p;
}

}  // namespace

extern "C" {

// ---- Ring API ----

// Create (producer side) a ring at `path` sized for `slots` payloads of
// `slot_size` bytes. Truncates any prior ring for the device.
void* vb_ring_create(const char* path, const char* device_id, uint32_t slots,
                     uint64_t slot_size) {
  if (slots == 0 || slot_size == 0) return nullptr;
  RingHeader tmp{};
  tmp.slot_size = slot_size;
  size_t stride = sizeof(SlotHeader) + ((slot_size + 63) & ~size_t(63));
  size_t total = sizeof(RingHeader) + stride * slots;
  unlink(path);  // fresh ring; readers re-open
  size_t mlen = 0;
  void* p = map_file(path, total, /*create=*/true, &mlen);
  if (!p) return nullptr;
  auto* hdr = reinterpret_cast<RingHeader*>(p);
  std::memset(p, 0, sizeof(RingHeader));
  hdr->version = kVersion;
  hdr->slots = slots;
  hdr->slot_size = slot_size;
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->writer_pid.store(static_cast<uint64_t>(getpid()),
                        std::memory_order_relaxed);
  std::snprintf(hdr->device_id, sizeof(hdr->device_id), "%s", device_id);
  std::atomic_thread_fence(std::memory_order_release);
  hdr->magic = kRingMagic;  // publish validity last
  auto* r = new Ring{hdr, static_cast<uint8_t*>(p), mlen, true};
  return r;
}

// Open (consumer side). Returns nullptr if missing/not yet initialized.
void* vb_ring_open(const char* path) {
  size_t mlen = 0;
  void* p = map_file(path, 0, /*create=*/false, &mlen);
  if (!p) return nullptr;
  auto* hdr = reinterpret_cast<RingHeader*>(p);
  if (mlen < sizeof(RingHeader) || hdr->magic != kRingMagic ||
      hdr->version != kVersion) {
    munmap(p, mlen);
    return nullptr;
  }
  auto* r = new Ring{hdr, static_cast<uint8_t*>(p), mlen, false};
  return r;
}

void vb_ring_close(void* handle) {
  if (!handle) return;
  auto* r = static_cast<Ring*>(handle);
  munmap(r->base, r->map_len);
  delete r;
}

uint64_t vb_ring_slot_size(void* handle) {
  return handle ? static_cast<Ring*>(handle)->hdr->slot_size : 0;
}

uint64_t vb_ring_head(void* handle) {
  return handle ? static_cast<Ring*>(handle)->hdr->head.load(
                      std::memory_order_acquire)
                : 0;
}

// Publish one frame; returns its sequence number (or 0 on error).
uint64_t vb_ring_publish(void* handle, const uint8_t* data, uint64_t len,
                         const FrameMeta* meta) {
  auto* r = static_cast<Ring*>(handle);
  if (!r || !r->writer || len > r->hdr->slot_size) return 0;
  uint64_t seq = r->hdr->head.load(std::memory_order_relaxed) + 1;
  SlotHeader* s = slot_at(r, (seq - 1) % r->hdr->slots);
  s->commit.fetch_add(1, std::memory_order_acq_rel);  // -> odd: writing
  s->seq = seq;
  s->data_len = len;
  if (meta) s->meta = *meta;
  std::memcpy(reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader), data, len);
  s->commit.fetch_add(1, std::memory_order_release);  // -> even: stable
  r->hdr->head.store(seq, std::memory_order_release);
  return seq;
}

// Copy out the newest frame with seq > min_seq. Returns its seq, 0 if nothing
// newer, or (uint64)-1 if `cap` is too small (needed size written to *len_out).
uint64_t vb_ring_read_latest(void* handle, uint64_t min_seq, uint8_t* out,
                             uint64_t cap, uint64_t* len_out, FrameMeta* meta_out) {
  auto* r = static_cast<Ring*>(handle);
  if (!r) return 0;
  for (int attempt = 0; attempt < 64; ++attempt) {
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (head == 0 || head <= min_seq) return 0;
    SlotHeader* s = slot_at(r, (head - 1) % r->hdr->slots);
    uint64_t c1 = s->commit.load(std::memory_order_acquire);
    if (c1 & 1) continue;  // write in progress; retry
    uint64_t len = s->data_len;
    uint64_t seq = s->seq;
    FrameMeta meta = s->meta;
    if (len > cap) {
      if (len_out) *len_out = len;
      return static_cast<uint64_t>(-1);
    }
    std::memcpy(out, reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader), len);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t c2 = s->commit.load(std::memory_order_acquire);
    if (c1 == c2 && seq > min_seq) {
      if (len_out) *len_out = len;
      if (meta_out) *meta_out = meta;
      return seq;
    }
    // Producer lapped us mid-copy; chase the new head.
  }
  return 0;
}

// ---- KV API ----

void* vb_kv_open(const char* path, uint32_t nslots) {
  size_t total = sizeof(KvHeader) + sizeof(KvEntry) * nslots;
  size_t mlen = 0;
  void* p = map_file(path, total, /*create=*/true, &mlen);
  if (!p) return nullptr;
  auto* hdr = reinterpret_cast<KvHeader*>(p);
  if (hdr->magic != kKvMagic) {
    // First opener initializes; concurrent first-open races are benign for
    // our usage (the server creates the KV before spawning any workers).
    std::memset(p, 0, total);
    hdr->version = kVersion;
    hdr->nslots = nslots;
    std::atomic_thread_fence(std::memory_order_release);
    hdr->magic = kKvMagic;
  }
  auto* kv = new Kv{hdr,
                    reinterpret_cast<KvEntry*>(static_cast<uint8_t*>(p) +
                                               sizeof(KvHeader)),
                    mlen};
  return kv;
}

void vb_kv_close(void* handle) {
  if (!handle) return;
  auto* kv = static_cast<Kv*>(handle);
  munmap(kv->hdr, kv->map_len);
  delete kv;
}

// Acquire the per-entry writer lock: spin until the seqlock word is even and
// we win the transition to odd. Serializes concurrent writers (multiple
// server threads / processes may set the same control key; the reference's
// Redis HSET was atomic and this preserves that).
inline void kv_write_lock(KvEntry* e) {
  for (;;) {
    uint64_t c = e->commit.load(std::memory_order_acquire);
    if ((c & 1) == 0 &&
        e->commit.compare_exchange_weak(c, c + 1,
                                        std::memory_order_acq_rel)) {
      return;
    }
  }
}

// Set key -> value. Returns 0 on success, -1 on table-full / oversize.
int32_t vb_kv_set(void* handle, const char* key, const uint8_t* val,
                  uint32_t len) {
  auto* kv = static_cast<Kv*>(handle);
  if (!kv || len > kValCap || std::strlen(key) >= kKeyCap) return -1;
  uint32_t n = kv->hdr->nslots;
  uint64_t h = fnv1a(key) % n;
  for (uint32_t i = 0; i < n; ++i) {
    KvEntry* e = &kv->entries[(h + i) % n];
    bool empty = e->key[0] == '\0';
    if (!empty && std::strncmp(e->key, key, kKeyCap) != 0) continue;
    kv_write_lock(e);
    if (e->key[0] == '\0') {
      std::snprintf(e->key, kKeyCap, "%s", key);
    } else if (std::strncmp(e->key, key, kKeyCap) != 0) {
      // Lost a claim race on an empty slot to a different key; release and
      // keep probing.
      e->commit.fetch_add(1, std::memory_order_release);
      continue;
    }
    e->len = len;
    std::memcpy(e->val, val, len);
    e->commit.fetch_add(1, std::memory_order_release);
    return 0;
  }
  return -1;
}

// Get value for key. Returns length, -1 if absent, -2 if cap too small.
int64_t vb_kv_get(void* handle, const char* key, uint8_t* out, uint32_t cap) {
  auto* kv = static_cast<Kv*>(handle);
  if (!kv) return -1;
  uint32_t n = kv->hdr->nslots;
  uint64_t h = fnv1a(key) % n;
  for (uint32_t i = 0; i < n; ++i) {
    KvEntry* e = &kv->entries[(h + i) % n];
    if (e->key[0] == '\0') return -1;  // linear-probe miss
    if (std::strncmp(e->key, key, kKeyCap) != 0) continue;
    for (int attempt = 0; attempt < 64; ++attempt) {
      uint64_t c1 = e->commit.load(std::memory_order_acquire);
      if (c1 & 1) continue;
      uint32_t len = e->len;
      if (len > cap) return -2;
      std::memcpy(out, e->val, len);
      std::atomic_thread_fence(std::memory_order_acquire);
      if (e->commit.load(std::memory_order_acquire) == c1)
        return static_cast<int64_t>(len);
    }
    return -1;
  }
  return -1;
}

// Delete key. Tombstone-free removal is unsafe with linear probing, so we
// keep the slot but zero the value and mark len=0 with a leading '\xff' len
// sentinel? -- simpler: overwrite value with empty; callers treat len==0 as
// absent-equivalent. Returns 0 if the key existed.
int32_t vb_kv_del(void* handle, const char* key) {
  auto* kv = static_cast<Kv*>(handle);
  if (!kv) return -1;
  uint32_t n = kv->hdr->nslots;
  uint64_t h = fnv1a(key) % n;
  for (uint32_t i = 0; i < n; ++i) {
    KvEntry* e = &kv->entries[(h + i) % n];
    if (e->key[0] == '\0') return -1;
    if (std::strncmp(e->key, key, kKeyCap) != 0) continue;
    kv_write_lock(e);
    e->len = 0;
    e->commit.fetch_add(1, std::memory_order_release);
    return 0;
  }
  return -1;
}

// ---- Doorbell API ----

// Open (create if missing) the bus-wide publish doorbell at `path`.
// Idempotent across processes; the init race is benign (a lost bump, and
// every waiter has a timeout).
void* vb_doorbell_open(const char* path) {
  size_t mlen = 0;
  void* p = map_file(path, sizeof(DoorbellShm), /*create=*/true, &mlen);
  if (!p) return nullptr;
  auto* shm = reinterpret_cast<DoorbellShm*>(p);
  if (shm->magic != kDoorbellMagic) {
    shm->version = kVersion;
    shm->value.store(0, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);
    shm->magic = kDoorbellMagic;
  }
  return new Doorbell{shm, mlen};
}

void vb_doorbell_close(void* handle) {
  if (!handle) return;
  auto* d = static_cast<Doorbell*>(handle);
  munmap(d->shm, d->map_len);
  delete d;
}

uint32_t vb_doorbell_value(void* handle) {
  auto* d = static_cast<Doorbell*>(handle);
  return d ? d->shm->value.load(std::memory_order_acquire) : 0;
}

// Bump the counter and wake every waiter. Called by producers after each
// ring publish; a FUTEX_WAKE with no waiters is a ~1 µs syscall.
void vb_doorbell_ring(void* handle) {
  auto* d = static_cast<Doorbell*>(handle);
  if (!d) return;
  d->shm->value.fetch_add(1, std::memory_order_release);
#ifdef __linux__
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(&d->shm->value), FUTEX_WAKE,
          INT32_MAX, nullptr, nullptr, 0);
#endif
}

// Block until the counter moves past `last` or `timeout_ms` elapses.
// Returns the current value either way. Process-shared futex on Linux;
// sleep-poll fallback elsewhere.
uint32_t vb_doorbell_wait(void* handle, uint32_t last, uint32_t timeout_ms) {
  auto* d = static_cast<Doorbell*>(handle);
  if (!d) return 0;
  std::atomic<uint32_t>* v = &d->shm->value;
  uint32_t cur = v->load(std::memory_order_acquire);
  if (cur != last) return cur;
#ifdef __linux__
  struct timespec ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = static_cast<long>(timeout_ms % 1000) * 1000000L;
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(v), FUTEX_WAIT, last, &ts,
          nullptr, 0);
#else
  usleep(static_cast<useconds_t>(timeout_ms) * 1000);
#endif
  return v->load(std::memory_order_acquire);
}

// Enumerate keys (newline-joined) into `out`. Returns bytes written.
int64_t vb_kv_keys(void* handle, uint8_t* out, uint64_t cap) {
  auto* kv = static_cast<Kv*>(handle);
  if (!kv) return -1;
  uint64_t w = 0;
  for (uint32_t i = 0; i < kv->hdr->nslots; ++i) {
    KvEntry* e = &kv->entries[i];
    if (e->key[0] == '\0' || e->len == 0) continue;
    size_t kl = strnlen(e->key, kKeyCap);
    if (w + kl + 1 > cap) return -2;
    std::memcpy(out + w, e->key, kl);
    w += kl;
    out[w++] = '\n';
  }
  return static_cast<int64_t>(w);
}

}  // extern "C"
