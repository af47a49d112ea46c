// Shared-memory SPSC ring buffer — the native same-host transport lane.
//
// Role in the framework: the reference's client<->server exchange rides
// ROS1 TCPROS even when every process shares one host
// (corbslam_server/src/main.cpp:49-55 services; PubToClient.cpp topics).
// This is the C++ runtime equivalent for the single-host deployment shape:
// one mmap'd ring per direction per client, length-prefixed frames, no
// sockets, no syscalls on the hot path (just atomic loads/stores + memcpy).
//
// Concurrency model: single producer / single consumer per ring (the
// framework's single-writer discipline — each ring has exactly one writing
// role). head = next write offset, tail = next read offset, both
// monotonically increasing uint64 wrapped by capacity; release/acquire
// pairs order the payload memcpy against the index publication.
//
// Build: g++ -O2 -shared -fPIC -o libshmring.so shm_ring.cc -lrt
// (driven by corbslam/collab/shm_ring.py at first import).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  std::atomic<uint64_t> head;  // bytes written (producer-owned)
  std::atomic<uint64_t> tail;  // bytes consumed (consumer-owned)
  uint64_t capacity;           // data area size, power of two
  std::atomic<uint64_t> magic; // release-published LAST; acquire-checked
                               // by csr_open before trusting other fields
  char _pad[64 - 4 * sizeof(uint64_t)];  // keep data cache-line clear
};

constexpr uint64_t kMagic = 0x43535231u;  // "CSR1"

struct Ring {
  RingHeader* hdr;
  uint8_t* data;
  uint64_t map_len;
  int owner;  // created (1) vs opened (0): owner unlinks on destroy
  char name[256];
};

inline uint64_t ring_mask(const Ring* r) { return r->hdr->capacity - 1; }

}  // namespace

extern "C" {

// Create (producer side). capacity is rounded up to a power of two.
void* csr_create(const char* name, uint64_t capacity) {
  uint64_t cap = 1;
  while (cap < capacity) cap <<= 1;
  shm_unlink(name);  // stale ring from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t len = sizeof(RingHeader) + cap;
  if (ftruncate(fd, (off_t)len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = (RingHeader*)mem;
  r->data = (uint8_t*)mem + sizeof(RingHeader);
  r->map_len = len;
  r->owner = 1;
  strncpy(r->name, name, sizeof(r->name) - 1);
  r->hdr->head.store(0, std::memory_order_relaxed);
  r->hdr->tail.store(0, std::memory_order_relaxed);
  r->hdr->capacity = cap;
  // Release-store publishes capacity/head/tail before magic becomes
  // visible; csr_open pairs with an acquire load.
  r->hdr->magic.store(kMagic, std::memory_order_release);
  return r;
}

// Open an existing ring (consumer side). Returns nullptr until the
// producer has finished csr_create.
void* csr_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(RingHeader)) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  RingHeader* hdr = (RingHeader*)mem;
  if (hdr->magic.load(std::memory_order_acquire) != kMagic) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = hdr;
  r->data = (uint8_t*)mem + sizeof(RingHeader);
  r->map_len = (uint64_t)st.st_size;
  r->owner = 0;
  strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

// Push one frame (u32 length prefix + payload). 0 = ok, -1 = not enough
// space (caller retries later; nothing is written).
int csr_push(void* h, const uint8_t* buf, uint32_t len) {
  Ring* r = (Ring*)h;
  uint64_t cap = r->hdr->capacity;
  uint64_t need = 4u + (uint64_t)len;
  if (need > cap) return -2;  // frame can never fit
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  if (cap - (head - tail) < need) return -1;
  uint64_t mask = ring_mask(r);
  uint32_t le_len = len;  // little-endian hosts only (x86/ARM LE)
  for (int i = 0; i < 4; ++i)
    r->data[(head + i) & mask] = ((uint8_t*)&le_len)[i];
  uint64_t off = head + 4;
  uint64_t first = std::min((uint64_t)len, cap - (off & mask));
  memcpy(r->data + (off & mask), buf, first);
  if (first < len) memcpy(r->data, buf + first, len - first);
  r->hdr->head.store(head + need, std::memory_order_release);
  return 0;
}

// Pop one frame into out (max_len bytes). Returns payload length, -1 if
// empty, -3 if out buffer too small (frame left in place; call again with
// a bigger buffer — peek the size with csr_peek).
int64_t csr_pop(void* h, uint8_t* out, uint64_t max_len) {
  Ring* r = (Ring*)h;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (head == tail) return -1;
  uint64_t mask = ring_mask(r);
  uint32_t len = 0;
  for (int i = 0; i < 4; ++i)
    ((uint8_t*)&len)[i] = r->data[(tail + i) & mask];
  if ((uint64_t)len > max_len) return -3;
  uint64_t off = tail + 4;
  uint64_t cap = r->hdr->capacity;
  uint64_t first = std::min((uint64_t)len, cap - (off & mask));
  memcpy(out, r->data + (off & mask), first);
  if (first < len) memcpy(out + first, r->data, len - first);
  r->hdr->tail.store(tail + 4u + len, std::memory_order_release);
  return (int64_t)len;
}

// Size of the next frame, -1 if empty.
int64_t csr_peek(void* h) {
  Ring* r = (Ring*)h;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (head == tail) return -1;
  uint64_t mask = ring_mask(r);
  uint32_t len = 0;
  for (int i = 0; i < 4; ++i)
    ((uint8_t*)&len)[i] = r->data[(tail + i) & mask];
  return (int64_t)len;
}

// Bytes currently queued (diagnostic).
uint64_t csr_used(void* h) {
  Ring* r = (Ring*)h;
  return r->hdr->head.load(std::memory_order_acquire) -
         r->hdr->tail.load(std::memory_order_acquire);
}

void csr_close(void* h) {
  Ring* r = (Ring*)h;
  int owner = r->owner;
  char name[256];
  strncpy(name, r->name, sizeof(name));
  munmap((void*)r->hdr, r->map_len);
  if (owner) shm_unlink(name);
  delete r;
}

}  // extern "C"
