// Shared-memory arena object store — the plasma equivalent
// (ref analog: src/ray/object_manager/plasma/{store.h:55,
// plasma_allocator, eviction_policy, object_lifecycle_manager}; dlmalloc
// over mmap'd shm in the reference, a boundary-tag first-fit arena here).
//
// One mmap'd POSIX shm segment per node holds a header + object table +
// arena. Every process on the node maps the same segment; metadata
// mutations run under a process-shared robust mutex. Object payloads are
// written by the creator between create() and seal() (no lock held — the
// offset is private until sealed) and read zero-copy by any process.
// Eviction: LRU over sealed, refcount-0 objects, driven on allocation
// failure (ref: eviction_policy.cc).
//
// Exposed as a C API for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cerrno>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5241595453484d31ULL;  // "RAYTSHM1"
constexpr uint64_t kIdSize = 24;  // ObjectID length (ids.py OBJECT_ID_LEN)
constexpr uint64_t kAlign = 64;

enum EntryState : uint8_t {
  kEmpty = 0,
  kCreating = 1,
  kSealed = 2,
  kTombstone = 3,     // deleted while refcount > 0; freed on last release
  kDeletedSlot = 4,   // slot free but part of a probe chain
};

struct Entry {
  uint8_t id[kIdSize];
  uint8_t state;
  uint8_t pad_[3];
  uint32_t refcount;
  uint64_t offset;  // payload offset from arena base
  uint64_t size;    // payload size
  uint64_t lru;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;     // arena bytes
  uint64_t table_slots;
  uint64_t lru_tick;
  uint64_t used_bytes;   // allocated block bytes (incl. block headers)
  uint64_t num_objects;
  uint64_t evictions;
  pthread_mutex_t mutex;
};

// boundary-tag block header, 64 bytes so payloads stay cache-aligned
struct Block {
  uint64_t size;       // total block size incl. this header
  uint64_t prev_size;  // size of previous block (0 for first)
  uint64_t used;
  uint64_t pad_[5];
};

struct Store {
  int fd;
  uint8_t* base;       // whole mapping
  uint64_t total_size;
  Header* hdr;
  Entry* table;
  uint8_t* arena;
};

uint64_t align_up(uint64_t n, uint64_t a) { return (n + a - 1) & ~(a - 1); }

uint64_t hash_id(const uint8_t* id) {
  uint64_t h = 1469598103934665603ULL;
  for (uint64_t i = 0; i < kIdSize; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return h;
}

class Locker {
 public:
  explicit Locker(Header* hdr) : hdr_(hdr) {
    int rc = pthread_mutex_lock(&hdr_->mutex);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&hdr_->mutex);
  }
  ~Locker() { pthread_mutex_unlock(&hdr_->mutex); }
 private:
  Header* hdr_;
};

Block* first_block(Store* s) { return reinterpret_cast<Block*>(s->arena); }

Block* next_block(Store* s, Block* b) {
  uint8_t* p = reinterpret_cast<uint8_t*>(b) + b->size;
  if (p >= s->arena + s->hdr->capacity) return nullptr;
  return reinterpret_cast<Block*>(p);
}

Block* prev_block(Store* s, Block* b) {
  if (b->prev_size == 0) return nullptr;
  return reinterpret_cast<Block*>(reinterpret_cast<uint8_t*>(b) - b->prev_size);
}

// first-fit allocate; returns payload offset into the arena or UINT64_MAX
uint64_t alloc_block(Store* s, uint64_t payload) {
  uint64_t need = align_up(payload + sizeof(Block), kAlign);
  for (Block* b = first_block(s); b; b = next_block(s, b)) {
    if (b->used || b->size < need) continue;
    uint64_t leftover = b->size - need;
    if (leftover >= sizeof(Block) + kAlign) {
      b->size = need;
      Block* rest = next_block(s, b);
      rest->size = leftover;
      rest->prev_size = need;
      rest->used = 0;
      Block* after = next_block(s, rest);
      if (after) after->prev_size = leftover;
    }
    b->used = 1;
    s->hdr->used_bytes += b->size;
    return reinterpret_cast<uint8_t*>(b) + sizeof(Block) - s->arena;
  }
  return UINT64_MAX;
}

void free_block(Store* s, uint64_t payload_offset) {
  Block* b = reinterpret_cast<Block*>(
      s->arena + payload_offset - sizeof(Block));
  b->used = 0;
  s->hdr->used_bytes -= b->size;
  // coalesce with next, then prev
  Block* n = next_block(s, b);
  if (n && !n->used) {
    b->size += n->size;
    Block* after = next_block(s, b);
    if (after) after->prev_size = b->size;
  }
  Block* p = prev_block(s, b);
  if (p && !p->used) {
    p->size += b->size;
    Block* after = next_block(s, p);
    if (after) after->prev_size = p->size;
  }
}

Entry* find_entry(Store* s, const uint8_t* id) {
  uint64_t slots = s->hdr->table_slots;
  uint64_t i = hash_id(id) % slots;
  for (uint64_t probes = 0; probes < slots; probes++, i = (i + 1) % slots) {
    Entry* e = &s->table[i];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kDeletedSlot && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

Entry* find_slot(Store* s, const uint8_t* id) {
  uint64_t slots = s->hdr->table_slots;
  uint64_t i = hash_id(id) % slots;
  Entry* first_free = nullptr;
  for (uint64_t probes = 0; probes < slots; probes++, i = (i + 1) % slots) {
    Entry* e = &s->table[i];
    if (e->state == kEmpty)
      return first_free ? first_free : e;
    if (e->state == kDeletedSlot) {
      if (!first_free) first_free = e;
    } else if (memcmp(e->id, id, kIdSize) == 0) {
      return nullptr;  // already present
    }
  }
  return first_free;
}

void drop_entry(Store* s, Entry* e) {
  free_block(s, e->offset);
  e->state = kDeletedSlot;
  e->refcount = 0;
  s->hdr->num_objects--;
}

// evict LRU sealed refcount-0 objects until try_alloc succeeds
uint64_t alloc_with_eviction(Store* s, uint64_t payload) {
  uint64_t off = alloc_block(s, payload);
  while (off == UINT64_MAX) {
    Entry* victim = nullptr;
    for (uint64_t i = 0; i < s->hdr->table_slots; i++) {
      Entry* e = &s->table[i];
      if (e->state == kSealed && e->refcount == 0 &&
          (!victim || e->lru < victim->lru))
        victim = e;
    }
    if (!victim) return UINT64_MAX;
    drop_entry(s, victim);
    s->hdr->evictions++;
    off = alloc_block(s, payload);
  }
  return off;
}

}  // namespace

extern "C" {

// error codes
// 0 ok; -1 not found / already exists; -2 out of memory; -3 not sealed;
// -4 io/init failure
#define RAYT_OK 0
#define RAYT_ERR_EXISTS (-1)
#define RAYT_ERR_NOMEM (-2)
#define RAYT_ERR_UNSEALED (-3)
#define RAYT_ERR_IO (-4)

void* rayt_shm_open(const char* name, uint64_t capacity,
                    uint64_t table_slots) {
  uint64_t hdr_bytes = align_up(sizeof(Header), kAlign);

  int fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0666);
  if (fd >= 0) {
    // ----- creator: size from caller-supplied capacity/table_slots -----
    uint64_t table_bytes = align_up(table_slots * sizeof(Entry), kAlign);
    uint64_t total = hdr_bytes + table_bytes + capacity;
    if (ftruncate(fd, (off_t)total) != 0) {
      close(fd); shm_unlink(name); return nullptr;
    }
    uint8_t* base = (uint8_t*)mmap(nullptr, total, PROT_READ | PROT_WRITE,
                                   MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { close(fd); return nullptr; }

    Store* s = new Store();
    s->fd = fd;
    s->base = base;
    s->total_size = total;
    s->hdr = reinterpret_cast<Header*>(base);
    s->table = reinterpret_cast<Entry*>(base + hdr_bytes);
    s->arena = base + hdr_bytes + table_bytes;

    memset(base, 0, hdr_bytes + table_bytes);
    s->hdr->capacity = capacity;
    s->hdr->table_slots = table_slots;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&s->hdr->mutex, &attr);
    Block* b = first_block(s);
    b->size = capacity;
    b->prev_size = 0;
    b->used = 0;
    __atomic_store_n(&s->hdr->magic, kMagic, __ATOMIC_RELEASE);
    return s;
  }

  // ----- attach: size the mapping from the EXISTING segment, never from
  // the caller's (possibly divergent) capacity config. Mapping fewer
  // bytes than the creator's arena would SIGBUS on first deep read.
  fd = shm_open(name, O_RDWR, 0666);
  if (fd < 0) return nullptr;

  // 1) wait for the creator's ftruncate (single call: size goes 0 -> total)
  struct stat st;
  st.st_size = 0;
  for (int i = 0; i < 10000; i++) {
    if (fstat(fd, &st) == 0 && (uint64_t)st.st_size >= hdr_bytes) break;
    usleep(1000);
  }
  if ((uint64_t)st.st_size < hdr_bytes) { close(fd); return nullptr; }
  uint64_t total = (uint64_t)st.st_size;

  uint8_t* base = (uint8_t*)mmap(nullptr, total, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Header* hdr = reinterpret_cast<Header*>(base);

  // 2) wait for the creator to finish initializing (magic is the release)
  bool ready = false;
  for (int i = 0; i < 10000; i++) {
    if (__atomic_load_n(&hdr->magic, __ATOMIC_ACQUIRE) == kMagic) {
      ready = true;
      break;
    }
    usleep(1000);
  }
  // 3) validate geometry recorded in the header against the real size
  uint64_t table_bytes =
      ready ? align_up(hdr->table_slots * sizeof(Entry), kAlign) : 0;
  if (!ready || hdr_bytes + table_bytes + hdr->capacity > total) {
    fprintf(stderr,
            "rayt_shm_open(%s): attach failed (ready=%d capacity=%llu "
            "table_slots=%llu segment=%llu)\n",
            name, (int)ready,
            ready ? (unsigned long long)hdr->capacity : 0ULL,
            ready ? (unsigned long long)hdr->table_slots : 0ULL,
            (unsigned long long)total);
    munmap(base, total);
    close(fd);
    return nullptr;
  }

  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->total_size = total;
  s->hdr = hdr;
  s->table = reinterpret_cast<Entry*>(base + hdr_bytes);
  s->arena = base + hdr_bytes + table_bytes;
  return s;
}

uint8_t* rayt_shm_base(void* handle) {
  return static_cast<Store*>(handle)->arena;
}

uint64_t rayt_shm_arena_offset(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return (uint64_t)(s->arena - s->base);
}

int rayt_shm_create(void* handle, const uint8_t* id, uint64_t size,
                    uint64_t* offset_out) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  if (find_entry(s, id)) return RAYT_ERR_EXISTS;
  Entry* e = find_slot(s, id);
  if (!e) return RAYT_ERR_NOMEM;  // table full
  uint64_t off = alloc_with_eviction(s, size ? size : 1);
  if (off == UINT64_MAX) return RAYT_ERR_NOMEM;
  memcpy(e->id, id, kIdSize);
  e->state = kCreating;
  e->refcount = 1;  // creator holds a ref until seal+release
  e->offset = off;
  e->size = size;
  e->lru = ++s->hdr->lru_tick;
  s->hdr->num_objects++;
  *offset_out = off;
  return RAYT_OK;
}

int rayt_shm_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  Entry* e = find_entry(s, id);
  if (!e) return RAYT_ERR_EXISTS;
  e->state = kSealed;
  e->lru = ++s->hdr->lru_tick;
  return RAYT_OK;
}

int rayt_shm_get(void* handle, const uint8_t* id, uint64_t* offset_out,
                 uint64_t* size_out) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  Entry* e = find_entry(s, id);
  if (!e || e->state == kTombstone) return RAYT_ERR_EXISTS;
  if (e->state != kSealed) return RAYT_ERR_UNSEALED;
  e->refcount++;
  e->lru = ++s->hdr->lru_tick;
  *offset_out = e->offset;
  *size_out = e->size;
  return RAYT_OK;
}

int rayt_shm_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  Entry* e = find_entry(s, id);
  if (!e) return RAYT_ERR_EXISTS;
  if (e->refcount > 0) e->refcount--;
  if (e->state == kTombstone && e->refcount == 0) drop_entry(s, e);
  return RAYT_OK;
}

int rayt_shm_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  Entry* e = find_entry(s, id);
  return (e && e->state == kSealed) ? 1 : 0;
}

int rayt_shm_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  Entry* e = find_entry(s, id);
  if (!e || e->state == kTombstone) return RAYT_ERR_EXISTS;
  if (e->refcount > 0) {
    e->state = kTombstone;  // freed on last release
    return RAYT_OK;
  }
  drop_entry(s, e);
  return RAYT_OK;
}

uint64_t rayt_shm_used(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  return s->hdr->used_bytes;
}

uint64_t rayt_shm_capacity(void* handle) {
  return static_cast<Store*>(handle)->hdr->capacity;
}

uint64_t rayt_shm_num_objects(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  return s->hdr->num_objects;
}

uint64_t rayt_shm_evictions(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Locker lock(s->hdr);
  return s->hdr->evictions;
}

void rayt_shm_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->total_size);
  close(s->fd);
  delete s;
}

int rayt_shm_unlink(const char* name) {
  return shm_unlink(name) == 0 ? RAYT_OK : RAYT_ERR_IO;
}

// ---- generic release/acquire atomics over shared mappings ----
// Used by the compiled-DAG SPSC ring (dag/channel.py): the producer's
// seq bump must be a RELEASE store (payload bytes visible before the
// seq) and the consumer's seq read an ACQUIRE load — correct on weakly
// ordered ISAs (ARM64), not just x86-TSO. The address must be 8-byte
// aligned (the ring header is cache-line aligned at mapping offset 0).
void rayt_atomic_store_release_u64(void* addr, uint64_t value) {
  __atomic_store_n(reinterpret_cast<uint64_t*>(addr), value,
                   __ATOMIC_RELEASE);
}

uint64_t rayt_atomic_load_acquire_u64(const void* addr) {
  return __atomic_load_n(reinterpret_cast<const uint64_t*>(addr),
                         __ATOMIC_ACQUIRE);
}

}  // extern "C"
