// Shared-memory object pool (copy of ray_tpu/native/shm_pool.cc for the
// PyTorch port; symbols and pool names carry the prefix rtpt_).
//
// Re-design of the reference's plasma store (reference:
// src/ray/object_manager/plasma/store.h, object_lifecycle_manager.h,
// eviction_policy.h) collapsed into a daemon-less design: instead of a store
// server process with a UDS protocol and fd-passing (plasma.fbs, fling.cc),
// all participating processes on a node mmap one tmpfs-backed pool file and
// coordinate through a process-shared robust mutex in the pool header. The
// object index is an open-addressing hash table in shared memory; the data
// region is managed by a first-fit free-list allocator with coalescing.
// Object payloads are immutable after seal (create -> write -> seal -> get),
// matching plasma's lifecycle, and readers pin objects with a refcount so
// deletion cannot race a mapped read.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libshm_pool.so shm_pool.cc -lpthread
// (ray_tpu_torch/native/build.py does this at first use).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <utility>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x5254505453484d31ULL;  // "RTPTSHM1"
constexpr uint32_t kKeyLen = 16;
constexpr uint32_t kTableCapacity = 1 << 16;  // 65536 slots, open addressing
constexpr uint64_t kAlign = 64;

enum SlotState : uint32_t {
  SLOT_FREE = 0,
  SLOT_CREATED = 1,   // allocated, being written
  SLOT_SEALED = 2,    // immutable, readable
  SLOT_TOMBSTONE = 3, // deleted (keeps probe chains intact)
};

struct ObjectSlot {
  uint8_t key[kKeyLen];
  uint64_t offset;  // into data region
  uint64_t size;    // payload bytes
  uint32_t state;
  int32_t refcount; // pins by readers; owner holds one implicit pin until delete
};

// Free/used block header preceding every data-region block.
struct BlockHeader {
  uint64_t size;       // payload capacity of this block (excludes header)
  uint64_t next_free;  // offset of next free block (valid when free)
  uint32_t is_free;
  uint32_t pad;
};

struct PoolHeader {
  uint64_t magic;
  uint64_t pool_size;
  uint64_t data_offset;     // start of data region
  uint64_t data_size;
  uint64_t free_head;       // offset (relative to data region) of first free block, or ~0
  uint64_t bytes_in_use;
  uint64_t num_objects;
  pthread_mutex_t lock;
  ObjectSlot table[kTableCapacity];
};

constexpr uint64_t kNoBlock = ~0ULL;

struct Pool {
  uint8_t* base = nullptr;
  uint64_t size = 0;
  int fd = -1;
  PoolHeader* hdr() { return reinterpret_cast<PoolHeader*>(base); }
  uint8_t* data() { return base + hdr()->data_offset; }
};

constexpr int kMaxPools = 64;
Pool g_pools[kMaxPools];
pthread_mutex_t g_pools_lock = PTHREAD_MUTEX_INITIALIZER;  // process-local

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t hash_key(const uint8_t* key) {
  // FNV-1a over the 16-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kKeyLen; i++) {
    h ^= key[i];
    h *= 1099511628211ULL;
  }
  return h;
}

void rebuild_allocator(Pool& p);

class LockGuard {
 public:
  explicit LockGuard(Pool& p) : m_(&p.hdr()->lock) {
    int rc = pthread_mutex_lock(m_);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock, possibly mid-way through free-list
      // surgery in alloc_block/free_block. The object table itself only sees
      // single-field state transitions, so it is trustworthy; rebuild the
      // entire block structure from it before continuing.
      pthread_mutex_consistent(m_);
      rebuild_allocator(p);
    }
  }
  ~LockGuard() { pthread_mutex_unlock(m_); }

 private:
  pthread_mutex_t* m_;
};

// Returns slot for key, or an insertable slot if absent (state FREE/TOMBSTONE),
// or nullptr if the table is full.
ObjectSlot* probe(PoolHeader* h, const uint8_t* key, bool for_insert) {
  uint64_t idx = hash_key(key) & (kTableCapacity - 1);
  ObjectSlot* first_tomb = nullptr;
  for (uint32_t i = 0; i < kTableCapacity; i++) {
    ObjectSlot* s = &h->table[(idx + i) & (kTableCapacity - 1)];
    if (s->state == SLOT_FREE) {
      if (!for_insert) return nullptr;
      return first_tomb ? first_tomb : s;
    }
    if (s->state == SLOT_TOMBSTONE) {
      if (first_tomb == nullptr) first_tomb = s;
      continue;
    }
    if (memcmp(s->key, key, kKeyLen) == 0) return s;
  }
  return for_insert ? first_tomb : nullptr;
}

// First-fit allocation from the free list. Returns data-region offset of the
// payload, or kNoBlock.
uint64_t alloc_block(Pool& p, uint64_t want) {
  PoolHeader* h = p.hdr();
  want = align_up(want, kAlign);
  uint64_t prev = kNoBlock;
  uint64_t cur = h->free_head;
  while (cur != kNoBlock) {
    BlockHeader* b = reinterpret_cast<BlockHeader*>(p.data() + cur);
    if (b->is_free && b->size >= want) {
      uint64_t remainder = b->size - want;
      if (remainder > sizeof(BlockHeader) + kAlign) {
        // Split: carve the tail into a new free block.
        uint64_t tail_off = cur + sizeof(BlockHeader) + want;
        BlockHeader* tail = reinterpret_cast<BlockHeader*>(p.data() + tail_off);
        tail->size = remainder - sizeof(BlockHeader);
        tail->is_free = 1;
        tail->next_free = b->next_free;
        b->size = want;
        if (prev == kNoBlock) h->free_head = tail_off;
        else reinterpret_cast<BlockHeader*>(p.data() + prev)->next_free = tail_off;
      } else {
        if (prev == kNoBlock) h->free_head = b->next_free;
        else reinterpret_cast<BlockHeader*>(p.data() + prev)->next_free = b->next_free;
      }
      b->is_free = 0;
      b->next_free = kNoBlock;
      h->bytes_in_use += b->size + sizeof(BlockHeader);
      return cur + sizeof(BlockHeader);
    }
    prev = cur;
    cur = b->next_free;
  }
  return kNoBlock;
}

void free_block(Pool& p, uint64_t payload_off) {
  PoolHeader* h = p.hdr();
  uint64_t cur = payload_off - sizeof(BlockHeader);
  BlockHeader* b = reinterpret_cast<BlockHeader*>(p.data() + cur);
  b->is_free = 1;
  h->bytes_in_use -= b->size + sizeof(BlockHeader);

  // Insert into address-ordered free list and coalesce with neighbors.
  uint64_t prev = kNoBlock;
  uint64_t it = h->free_head;
  while (it != kNoBlock && it < cur) {
    prev = it;
    it = reinterpret_cast<BlockHeader*>(p.data() + it)->next_free;
  }
  b->next_free = it;
  if (prev == kNoBlock) h->free_head = cur;
  else reinterpret_cast<BlockHeader*>(p.data() + prev)->next_free = cur;

  // Coalesce forward.
  if (it != kNoBlock && cur + sizeof(BlockHeader) + b->size == it) {
    BlockHeader* nb = reinterpret_cast<BlockHeader*>(p.data() + it);
    b->size += sizeof(BlockHeader) + nb->size;
    b->next_free = nb->next_free;
  }
  // Coalesce backward.
  if (prev != kNoBlock) {
    BlockHeader* pb = reinterpret_cast<BlockHeader*>(p.data() + prev);
    if (prev + sizeof(BlockHeader) + pb->size == cur) {
      pb->size += sizeof(BlockHeader) + b->size;
      pb->next_free = b->next_free;
    }
  }
}

// Reconstructs block headers and the free list from the object table (the
// table is the source of truth; block metadata may be torn after a crash).
// Slots in CREATED state are kept allocated: their writer may still be alive;
// if it died the space leaks until the object is deleted, never corrupts.
void rebuild_allocator(Pool& p) {
  PoolHeader* h = p.hdr();
  std::vector<std::pair<uint64_t, uint64_t>> used;  // (payload offset, size)
  used.reserve(h->num_objects);
  for (uint32_t i = 0; i < kTableCapacity; i++) {
    ObjectSlot* s = &h->table[i];
    if (s->state == SLOT_CREATED || s->state == SLOT_SEALED) {
      used.emplace_back(s->offset, s->size);
    }
  }
  std::sort(used.begin(), used.end());
  h->free_head = kNoBlock;
  h->bytes_in_use = 0;
  uint64_t prev_free = kNoBlock;
  uint64_t cursor = 0;  // current position in the data region
  auto emit_free = [&](uint64_t start, uint64_t end) {
    if (end <= start + sizeof(BlockHeader)) return;  // sliver too small, leak it
    BlockHeader* b = reinterpret_cast<BlockHeader*>(p.data() + start);
    b->size = end - start - sizeof(BlockHeader);
    b->is_free = 1;
    b->next_free = kNoBlock;
    if (prev_free == kNoBlock) h->free_head = start;
    else reinterpret_cast<BlockHeader*>(p.data() + prev_free)->next_free = start;
    prev_free = start;
  };
  for (auto& [payload_off, size] : used) {
    uint64_t block_off = payload_off - sizeof(BlockHeader);
    emit_free(cursor, block_off);
    BlockHeader* b = reinterpret_cast<BlockHeader*>(p.data() + block_off);
    b->size = align_up(size ? size : 1, kAlign);
    b->is_free = 0;
    b->next_free = kNoBlock;
    h->bytes_in_use += b->size + sizeof(BlockHeader);
    cursor = block_off + sizeof(BlockHeader) + b->size;
  }
  emit_free(cursor, h->data_size);
}

}  // namespace

extern "C" {

// Creates and initializes a pool file. Returns 0 or -errno.
int rtpt_pool_create(const char* path, uint64_t pool_size) {
  // The header (its object table) must fit with room for one block; a
  // smaller pool would be written past its end.
  if (pool_size < align_up(sizeof(PoolHeader), 4096) + sizeof(BlockHeader) + kAlign) {
    return -EINVAL;
  }
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return -errno;
  if (ftruncate(fd, (off_t)pool_size) != 0) {
    int e = errno;
    close(fd);
    unlink(path);
    return -e;
  }
  void* base = mmap(nullptr, pool_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    int e = errno;
    close(fd);
    unlink(path);
    return -e;
  }
  PoolHeader* h = reinterpret_cast<PoolHeader*>(base);
  memset(h, 0, sizeof(PoolHeader));
  h->pool_size = pool_size;
  h->data_offset = align_up(sizeof(PoolHeader), 4096);
  h->data_size = pool_size - h->data_offset;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  // One giant free block spanning the data region.
  BlockHeader* b = reinterpret_cast<BlockHeader*>(
      reinterpret_cast<uint8_t*>(base) + h->data_offset);
  b->size = h->data_size - sizeof(BlockHeader);
  b->is_free = 1;
  b->next_free = kNoBlock;
  h->free_head = 0;
  h->magic = kMagic;  // last: marks the pool initialized

  munmap(base, pool_size);
  close(fd);
  return 0;
}

// Attaches to an existing pool. Returns handle >= 0 or -errno.
int rtpt_pool_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    int e = errno;
    close(fd);
    return -e;
  }
  PoolHeader* h = reinterpret_cast<PoolHeader*>(base);
  if (h->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    return -EINVAL;
  }
  pthread_mutex_lock(&g_pools_lock);
  int idx = -1;
  for (int i = 0; i < kMaxPools; i++) {
    if (g_pools[i].base == nullptr) {
      idx = i;
      break;
    }
  }
  if (idx < 0) {
    pthread_mutex_unlock(&g_pools_lock);
    munmap(base, (size_t)st.st_size);
    close(fd);
    return -ENOSPC;
  }
  g_pools[idx].base = reinterpret_cast<uint8_t*>(base);
  g_pools[idx].size = (uint64_t)st.st_size;
  g_pools[idx].fd = fd;
  pthread_mutex_unlock(&g_pools_lock);
  return idx;
}

// Guards every entry point against stale/closed handles: Python finalizers
// (zero-copy pins, eager ref drops) can run after pool detach, and an
// unchecked g_pools[-1] is out-of-bounds UB.
bool rtpt_valid(int handle) {
  return handle >= 0 && handle < kMaxPools && g_pools[handle].base != nullptr;
}

// Allocates space for an object. Out: offset of payload from pool base.
// Returns 0, -EEXIST, -ENOMEM (pool full) or -ENOSPC (table full).
int rtpt_create(int handle, const uint8_t* key, uint64_t size, uint64_t* out_offset) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, /*for_insert=*/true);
  if (s == nullptr) return -ENOSPC;
  if (s->state == SLOT_CREATED || s->state == SLOT_SEALED) return -EEXIST;
  uint64_t off = alloc_block(p, size ? size : 1);
  if (off == kNoBlock) return -ENOMEM;
  memcpy(s->key, key, kKeyLen);
  s->offset = off;
  s->size = size;
  s->state = SLOT_CREATED;
  s->refcount = 0;
  h->num_objects++;
  *out_offset = h->data_offset + off;
  return 0;
}

int rtpt_seal(int handle, const uint8_t* key) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, false);
  if (s == nullptr || s->state == SLOT_TOMBSTONE) return -ENOENT;
  if (s->state == SLOT_SEALED) return -EALREADY;
  s->state = SLOT_SEALED;
  return 0;
}

// Looks up a sealed object and pins it (refcount++). Returns 0, -ENOENT, or
// -EAGAIN if created but not yet sealed.
int rtpt_get(int handle, const uint8_t* key, uint64_t* out_offset, uint64_t* out_size) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, false);
  if (s == nullptr) return -ENOENT;
  if (s->state == SLOT_CREATED) return -EAGAIN;
  if (s->state != SLOT_SEALED) return -ENOENT;
  s->refcount++;
  *out_offset = h->data_offset + s->offset;
  *out_size = s->size;
  return 0;
}

// Checks existence without pinning. Returns 1 sealed, 0 in-progress, -ENOENT.
int rtpt_contains(int handle, const uint8_t* key) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, false);
  if (s == nullptr || s->state == SLOT_TOMBSTONE) return -ENOENT;
  return s->state == SLOT_SEALED ? 1 : 0;
}

// Unpins a previously gotten object.
int rtpt_release(int handle, const uint8_t* key) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, false);
  if (s == nullptr) return -ENOENT;
  if (s->refcount > 0) s->refcount--;
  return 0;
}

// Deletes an object; frees immediately if unpinned, else marks for later
// delete-on-release semantics are handled by the caller re-invoking delete.
// Returns 0 freed, -EBUSY still pinned, -ENOENT.
int rtpt_delete(int handle, const uint8_t* key) {
  if (!rtpt_valid(handle)) return -EINVAL;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  ObjectSlot* s = probe(h, key, false);
  if (s == nullptr || s->state == SLOT_TOMBSTONE) return -ENOENT;
  if (s->refcount > 0) return -EBUSY;
  free_block(p, s->offset);
  s->state = SLOT_TOMBSTONE;
  h->num_objects--;
  return 0;
}

// The payload size of the largest free block: the most one allocation can
// take now. First fit leaves holes between live blocks, so bytes_in_use alone
// cannot say whether an object of a given size fits.
uint64_t rtpt_largest_free(int handle) {
  if (!rtpt_valid(handle)) return 0;
  Pool& p = g_pools[handle];
  PoolHeader* h = p.hdr();
  LockGuard g(p);
  uint64_t best = 0;
  for (uint64_t cur = h->free_head; cur != kNoBlock;) {
    BlockHeader* b = reinterpret_cast<BlockHeader*>(p.data() + cur);
    if (b->is_free && b->size > best) best = b->size;
    cur = b->next_free;
  }
  return best;
}

uint64_t rtpt_bytes_in_use(int handle) { if (!rtpt_valid(handle)) return 0; return g_pools[handle].hdr()->bytes_in_use; }
uint64_t rtpt_num_objects(int handle) { if (!rtpt_valid(handle)) return 0; return g_pools[handle].hdr()->num_objects; }
uint64_t rtpt_capacity(int handle) { if (!rtpt_valid(handle)) return 0; return g_pools[handle].hdr()->data_size; }

int rtpt_pool_detach(int handle) {
  if (handle < 0 || handle >= kMaxPools) return -EINVAL;
  pthread_mutex_lock(&g_pools_lock);
  Pool& p = g_pools[handle];
  if (p.base) munmap(p.base, p.size);
  if (p.fd >= 0) close(p.fd);
  p.base = nullptr;
  p.size = 0;
  p.fd = -1;
  pthread_mutex_unlock(&g_pools_lock);
  return 0;
}

}  // extern "C"
