// Shared-memory object store ("plasma-lite") for the TPU-native runtime.
//
// Role analog: the reference's per-node plasma store
// (src/ray/object_manager/plasma/store.cc — PlasmaStore, ObjectLifecycleManager,
// EvictionPolicy) which serves clients over a unix socket with flatbuffers.
// TPU-first redesign: instead of a store *server* process brokering every
// create/get over a socket, the arena and its metadata live directly in one
// shared-memory segment that every worker process on the host maps. All
// operations are lock-protected in-place updates — create/get/seal cost a
// futex acquisition plus table lookup, no IPC round trip. Data transfer is
// zero-copy: Python maps the same segment and reads object payloads as
// buffers. This matches TPU hosts' usage (few large tensor/checkpoint blobs,
// many small control objects) better than a socket protocol.
//
// Layout of the segment:
//   [Header | ObjectEntry table | data arena]
// Allocation: boundary-tag first-fit free list with coalescing, protected by a
// process-shared robust mutex in the header.
//
// Exposed as a plain C ABI consumed by ctypes (ray_tpu/core/object_store.py).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52544F5253484D31ULL;  // "RTORSHM1"
constexpr uint32_t kIdSize = 20;                    // ObjectID is 20 bytes
constexpr uint32_t kTableSize = 1 << 16;            // open-addressed entries
constexpr uint64_t kAlign = 64;

enum ObjState : uint32_t {
  kEmpty = 0,
  kCreated = 1,
  kSealed = 2,
  kTombstone = 3,
};

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;    // data offset from segment base
  uint64_t data_size;
  uint64_t meta_size; // metadata bytes appended after data
  int64_t ref_count;  // pinned readers (eviction guard)
  uint64_t create_ns; // creation stamp for LRU-ish eviction
};

// Free block header embedded in the arena. Allocated blocks carry the same
// header so free() can find the size; boundary tag at the end enables
// backward coalescing.
struct BlockHeader {
  uint64_t size;      // total block size incl. headers
  uint64_t prev_size; // size of physically-previous block (0 if first)
  uint32_t free_flag; // 1 if free
  uint32_t pad;
  uint64_t next_free; // offset of next free block (0 = none); valid if free
  uint64_t prev_free;
};

struct Header {
  uint64_t magic;
  uint64_t segment_size;
  uint64_t arena_offset;
  uint64_t arena_size;
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t free_head;  // offset of first free block (0 = none)
  uint64_t clock;      // monotone counter for create stamps
  uint64_t highwater;  // max bytes_in_use ever observed (arena pressure)
  pthread_mutex_t mutex;
  ObjectEntry table[kTableSize];
};

struct Store {
  int fd;
  uint8_t* base;
  Header* hdr;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class Guard {
 public:
  explicit Guard(Header* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->mutex);
    if (rc == EOWNERDEAD) {
      // A worker died holding the lock; state is still consistent enough for
      // our in-place updates (each op is short); mark recovered.
      pthread_mutex_consistent(&h_->mutex);
    }
  }
  ~Guard() { pthread_mutex_unlock(&h_->mutex); }

 private:
  Header* h_;
};

ObjectEntry* find_entry(Header* h, const uint8_t* id) {
  uint64_t idx = hash_id(id) & (kTableSize - 1);
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    ObjectEntry* e = &h->table[(idx + probe) & (kTableSize - 1)];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kTombstone && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

ObjectEntry* find_slot(Header* h, const uint8_t* id) {
  uint64_t idx = hash_id(id) & (kTableSize - 1);
  ObjectEntry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    ObjectEntry* e = &h->table[(idx + probe) & (kTableSize - 1)];
    if (e->state == kEmpty) return first_tomb ? first_tomb : e;
    if (e->state == kTombstone) {
      if (!first_tomb) first_tomb = e;
    } else if (memcmp(e->id, id, kIdSize) == 0) {
      return e;  // existing
    }
  }
  return first_tomb;
}

BlockHeader* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(s->base + off);
}

void freelist_remove(Header* h, Store* s, BlockHeader* b, uint64_t off) {
  if (b->prev_free)
    block_at(s, b->prev_free)->next_free = b->next_free;
  else
    h->free_head = b->next_free;
  if (b->next_free) block_at(s, b->next_free)->prev_free = b->prev_free;
}

void freelist_push(Header* h, Store* s, BlockHeader* b, uint64_t off) {
  b->free_flag = 1;
  b->next_free = h->free_head;
  b->prev_free = 0;
  if (h->free_head) block_at(s, h->free_head)->prev_free = off;
  h->free_head = off;
}

// Allocate `need` bytes of payload; returns data offset or 0 on OOM.
uint64_t arena_alloc(Store* s, uint64_t need) {
  Header* h = s->hdr;
  uint64_t total = align_up(need + sizeof(BlockHeader));
  uint64_t off = h->free_head;
  while (off) {
    BlockHeader* b = block_at(s, off);
    if (b->size >= total) {
      freelist_remove(h, s, b, off);
      uint64_t remainder = b->size - total;
      if (remainder >= sizeof(BlockHeader) + kAlign) {
        // Split: tail becomes a new free block.
        b->size = total;
        uint64_t tail_off = off + total;
        BlockHeader* tail = block_at(s, tail_off);
        tail->size = remainder;
        tail->prev_size = total;
        freelist_push(h, s, tail, tail_off);
        // Fix prev_size of the block after the tail.
        uint64_t after = tail_off + remainder;
        if (after < h->arena_offset + h->arena_size)
          block_at(s, after)->prev_size = remainder;
      }
      b->free_flag = 0;
      h->bytes_in_use += b->size;
      if (h->bytes_in_use > h->highwater) h->highwater = h->bytes_in_use;
      return off + sizeof(BlockHeader);
    }
    off = b->next_free;
  }
  return 0;
}

void arena_free(Store* s, uint64_t data_off) {
  Header* h = s->hdr;
  uint64_t off = data_off - sizeof(BlockHeader);
  BlockHeader* b = block_at(s, off);
  h->bytes_in_use -= b->size;
  // Coalesce forward.
  uint64_t next_off = off + b->size;
  uint64_t arena_end = h->arena_offset + h->arena_size;
  if (next_off < arena_end) {
    BlockHeader* nb = block_at(s, next_off);
    if (nb->free_flag) {
      freelist_remove(h, s, nb, next_off);
      b->size += nb->size;
    }
  }
  // Coalesce backward.
  if (b->prev_size) {
    uint64_t prev_off = off - b->prev_size;
    BlockHeader* pb = block_at(s, prev_off);
    if (pb->free_flag) {
      freelist_remove(h, s, pb, prev_off);
      pb->size += b->size;
      b = pb;
      off = prev_off;
    }
  }
  // Fix prev_size of following block.
  uint64_t after = off + b->size;
  if (after < arena_end) block_at(s, after)->prev_size = b->size;
  freelist_push(h, s, b, off);
}

}  // namespace

extern "C" {

// Create a new store segment (unlinks any existing one of the same name).
// Returns opaque handle or null.
void* shm_store_create(const char* name, uint64_t segment_size) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (segment_size < sizeof(Header) + (1 << 20)) segment_size = sizeof(Header) + (1 << 20);
  if (ftruncate(fd, static_cast<off_t>(segment_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, segment_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // NOTE on pre-population: tmpfs allocates a page on its first WRITE
  // fault, so an un-touched arena costs ~25k faults + kernel zeroing per
  // 100 MiB on the very first object writes. An eager synchronous
  // MADV_POPULATE_WRITE here was measured to degrade pathologically as
  // populated segments accumulate (0.2s -> 10s per 512 MiB arena on the
  // deployment kernel), serializing node registration; the Python side
  // now populates in bounded chunks from a background thread instead.
  Store* s = new Store{fd, static_cast<uint8_t*>(base), static_cast<Header*>(base)};
  Header* h = s->hdr;
  memset(h, 0, sizeof(Header));
  h->segment_size = segment_size;
  h->arena_offset = align_up(sizeof(Header));
  h->arena_size = segment_size - h->arena_offset;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  // One giant free block spanning the arena.
  BlockHeader* b = block_at(s, h->arena_offset);
  b->size = h->arena_size;
  b->prev_size = 0;
  freelist_push(h, s, b, h->arena_offset);
  h->magic = kMagic;
  return s;
}

// Attach to an existing segment created by shm_store_create.
void* shm_store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store{fd, static_cast<uint8_t*>(base), static_cast<Header*>(base)};
  if (s->hdr->magic != kMagic) {
    munmap(base, static_cast<size_t>(st.st_size));
    close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

void shm_store_detach(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->hdr->segment_size);
  close(s->fd);
  delete s;
}

void shm_store_destroy(void* handle, const char* name) {
  shm_store_detach(handle);
  shm_unlink(name);
}

// Create an object. Returns data offset (>0), 0 on OOM, -1 if already exists.
int64_t shm_store_create_object(void* handle, const uint8_t* id, uint64_t data_size,
                                uint64_t meta_size) {
  Store* s = static_cast<Store*>(handle);
  Header* h = s->hdr;
  Guard g(h);
  ObjectEntry* existing = find_entry(h, id);
  if (existing) return -1;
  ObjectEntry* e = find_slot(h, id);
  if (!e) return 0;
  uint64_t off = arena_alloc(s, data_size + meta_size);
  if (!off) return 0;
  memcpy(e->id, id, kIdSize);
  e->state = kCreated;
  e->offset = off;
  e->data_size = data_size;
  e->meta_size = meta_size;
  e->ref_count = 0;
  e->create_ns = ++h->clock;
  h->num_objects++;
  return static_cast<int64_t>(off);
}

int shm_store_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s->hdr, id);
  if (!e || e->state != kCreated) return -1;
  e->state = kSealed;
  return 0;
}

// Get a sealed object, pinning it. out = [offset, data_size, meta_size].
// Returns 0 on success, -1 not found, -2 not sealed yet.
int shm_store_get(void* handle, const uint8_t* id, uint64_t* out) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s->hdr, id);
  if (!e) return -1;
  if (e->state != kSealed) return -2;
  e->ref_count++;
  out[0] = e->offset;
  out[1] = e->data_size;
  out[2] = e->meta_size;
  return 0;
}

// Check existence/sealed without pinning.
int shm_store_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s->hdr, id);
  if (!e) return 0;
  return e->state == kSealed ? 1 : 2;
}

int shm_store_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s->hdr, id);
  if (!e) return -1;
  if (e->ref_count > 0) e->ref_count--;
  return 0;
}

// Delete object (frees arena space). Fails with -2 if pinned.
int shm_store_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Header* h = s->hdr;
  Guard g(h);
  ObjectEntry* e = find_entry(h, id);
  if (!e) return -1;
  if (e->ref_count > 0) return -2;
  arena_free(s, e->offset);
  e->state = kTombstone;
  h->num_objects--;
  return 0;
}

// Evict up to `need` bytes of sealed, unpinned objects (oldest first).
// Writes evicted ids packed into out_ids (capacity max_ids), returns count.
int shm_store_evict(void* handle, uint64_t need, uint8_t* out_ids, int max_ids) {
  Store* s = static_cast<Store*>(handle);
  Header* h = s->hdr;
  Guard g(h);
  int count = 0;
  uint64_t freed = 0;
  while (freed < need && count < max_ids) {
    ObjectEntry* victim = nullptr;
    for (uint32_t i = 0; i < kTableSize; i++) {
      ObjectEntry* e = &h->table[i];
      if (e->state == kSealed && e->ref_count == 0 &&
          (!victim || e->create_ns < victim->create_ns))
        victim = e;
    }
    if (!victim) break;
    freed += victim->data_size + victim->meta_size;
    memcpy(out_ids + count * kIdSize, victim->id, kIdSize);
    count++;
    arena_free(s, victim->offset);
    victim->state = kTombstone;
    h->num_objects--;
  }
  return count;
}

// List sealed objects: packs up to max_ids ids (20 bytes each) into
// out_ids and their total sizes (data + metadata) into out_sizes;
// returns the count. The holder-report path: a node agent re-registering
// with a restarted head enumerates its arena so the head can rebuild the
// object directory from holder truth (the directory is deliberately not
// written to the head WAL).
int shm_store_list(void* handle, uint8_t* out_ids, uint64_t* out_sizes,
                   int max_ids) {
  Store* s = static_cast<Store*>(handle);
  Header* h = s->hdr;
  Guard g(h);
  int count = 0;
  for (uint32_t i = 0; i < kTableSize && count < max_ids; i++) {
    ObjectEntry* e = &h->table[i];
    if (e->state != kSealed) continue;
    memcpy(out_ids + count * kIdSize, e->id, kIdSize);
    out_sizes[count] = e->data_size + e->meta_size;
    count++;
  }
  return count;
}

// One-pass arena accounting snapshot under a single lock acquisition
// (the memory-observatory sampling path; cheap enough for a heartbeat
// cadence — one 64k-entry table scan, no allocation). Writes 10 values:
//   [capacity, bytes_in_use, highwater, num_objects,
//    sealed_count, sealed_bytes, unsealed_count, unsealed_bytes,
//    pinned_count, pinned_bytes]
// sealed/unsealed bytes are PAYLOAD bytes (data + metadata) so they
// compare exactly against the directory's per-object sizes; bytes_in_use
// additionally carries block headers + alignment slack.
void shm_store_memory_stats(void* handle, uint64_t* out) {
  Store* s = static_cast<Store*>(handle);
  Header* h = s->hdr;
  Guard g(h);
  uint64_t sealed_count = 0, sealed_bytes = 0, sealed_data_bytes = 0;
  uint64_t unsealed_count = 0, unsealed_bytes = 0;
  uint64_t pinned_count = 0, pinned_bytes = 0;
  for (uint32_t i = 0; i < kTableSize; i++) {
    ObjectEntry* e = &h->table[i];
    if (e->state != kSealed && e->state != kCreated) continue;
    uint64_t payload = e->data_size + e->meta_size;
    if (e->state == kSealed) {
      sealed_count++;
      sealed_bytes += payload;
      // data-only view: the wire size convention (directory entries,
      // stripe ranges, pull buffers) excludes the frame-size metadata
      sealed_data_bytes += e->data_size;
    } else {
      unsealed_count++;
      unsealed_bytes += payload;
    }
    if (e->ref_count > 0) {
      pinned_count++;
      pinned_bytes += payload;
    }
  }
  out[0] = h->arena_size;
  out[1] = h->bytes_in_use;
  out[2] = h->highwater;
  out[3] = h->num_objects;
  out[4] = sealed_count;
  out[5] = sealed_bytes;
  out[6] = unsealed_count;
  out[7] = unsealed_bytes;
  out[8] = pinned_count;
  out[9] = pinned_bytes;
  out[10] = sealed_data_bytes;
}

uint64_t shm_store_bytes_in_use(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  return s->hdr->bytes_in_use;
}

uint64_t shm_store_capacity(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s->hdr->arena_size;
}

uint64_t shm_store_num_objects(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  return s->hdr->num_objects;
}

// Segment base address in THIS process — offsets from shm_store_get /
// shm_store_create_object resolve against it (the C++ client's zero-copy
// views; Python uses its own mmap of the same segment instead).
void* shm_store_base_ptr(void* handle) {
  return static_cast<Store*>(handle)->base;
}

}  // extern "C"
