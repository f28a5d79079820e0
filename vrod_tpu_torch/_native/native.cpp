// vrod-tpu native host runtime: WAL + slot allocator.
//
// The reference (sekulas/vRod) creates an empty `vr_wal` file at DB init
// (src/database/setup.rs:22-23) and declares a TruncateWalCommand
// (src/command/types.rs:44-54) but never implements the log itself. This is
// the real thing: a CRC32-framed append-only write-ahead log with fsync,
// replay (stopping at the first torn/corrupt frame), repair (truncate the
// torn tail) and truncate; plus the host-side slot allocator that backs the
// HBM-resident collection tensors (free-list slot acquisition, delete
// bitmap, id<->slot binding, compaction planning).
//
// Exposed as a C ABI for Python ctypes (pybind11 is not available in the
// build environment).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>

#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

// ---------------------------------------------------------------------------
// CRC32 (IEEE 802.3 polynomial, zlib-compatible)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];

static bool crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  return true;
}

// C++11 magic static: thread-safe one-time init. A plain bool flag was a
// data race (two threads' first CRC could read a half-built table and
// stamp a durable frame with a wrong checksum).
static void crc_ensure() { static const bool done = crc_init(); (void)done; }

extern "C" uint32_t vrod_crc32(const uint8_t* data, uint64_t len) {
  crc_ensure();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// CRC over the frame's (lsn, payload_len) header fields then the payload —
// zlib-compatible incremental continuation.
static uint32_t frame_crc(uint64_t lsn, uint32_t payload_len,
                          const uint8_t* payload) {
  crc_ensure();
  uint8_t hdr[12];
  memcpy(hdr, &lsn, 8);
  memcpy(hdr + 8, &payload_len, 4);
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < 12; i++) c = crc_table[(c ^ hdr[i]) & 0xFF] ^ (c >> 8);
  for (uint64_t i = 0; i < payload_len; i++)
    c = crc_table[(c ^ payload[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// WAL
//
// Frame layout (little-endian):
//   u32 magic = 0x315F4C57 ("WL_1")
//   u64 lsn   (1-based, strictly increasing)
//   u32 payload_len
//   u32 crc32(lsn || payload_len || payload)   — covers header AND payload,
//       so a zero-filled or stale header can never masquerade as a frame
//   u8  payload[payload_len]
// ---------------------------------------------------------------------------

static const uint32_t WAL_MAGIC = 0x315F4C57u;
static const uint32_t WAL_HEADER_SIZE = 4 + 8 + 4 + 4;

struct WalFrame {
  uint64_t lsn;
  uint64_t payload_offset;
  uint32_t payload_len;
};

struct Wal {
  int fd = -1;
  std::string path;
  uint64_t next_lsn = 1;       // lsn to assign to the next append
  uint64_t valid_size = 0;     // byte offset of end of last valid frame
  std::vector<WalFrame> index; // valid frames, in order
  bool scanned = false;
  // Set when an error path left in-memory state untrustworthy (e.g. the
  // post-swap rescan in truncate_until failed): appends refuse instead of
  // overwriting surviving frames at a bogus offset.
  bool broken = false;
};

static bool wal_scan(Wal* w) {
  // Build the frame index by scanning the file; stop at the first frame that
  // is torn (short) or fails magic/CRC. Everything before that point is the
  // durable prefix.
  w->index.clear();
  w->valid_size = 0;
  w->next_lsn = 1;
  off_t file_size = lseek(w->fd, 0, SEEK_END);
  if (file_size < 0) return false;
  uint64_t off = 0;
  std::vector<uint8_t> buf;
  while (off + WAL_HEADER_SIZE <= (uint64_t)file_size) {
    uint8_t header[WAL_HEADER_SIZE];
    if (pread(w->fd, header, WAL_HEADER_SIZE, off) != (ssize_t)WAL_HEADER_SIZE) break;
    uint32_t magic, payload_len, crc;
    uint64_t lsn;
    memcpy(&magic, header, 4);
    memcpy(&lsn, header + 4, 8);
    memcpy(&payload_len, header + 12, 4);
    memcpy(&crc, header + 16, 4);
    if (magic != WAL_MAGIC) break;
    if (off + WAL_HEADER_SIZE + payload_len > (uint64_t)file_size) break;  // torn
    buf.resize(payload_len);
    if (payload_len > 0 &&
        pread(w->fd, buf.data(), payload_len, off + WAL_HEADER_SIZE) !=
            (ssize_t)payload_len)
      break;
    if (frame_crc(lsn, payload_len, buf.data()) != crc) break;  // corrupt
    WalFrame f;
    f.lsn = lsn;
    f.payload_offset = off + WAL_HEADER_SIZE;
    f.payload_len = payload_len;
    w->index.push_back(f);
    off += WAL_HEADER_SIZE + payload_len;
    w->valid_size = off;
    w->next_lsn = lsn + 1;
  }
  w->scanned = true;
  return true;
}

extern "C" void* vrod_wal_open(const char* path) {
  Wal* w = new Wal();
  w->path = path;
  // A leftover .tmp from a crashed truncate_until rewrite is garbage (the
  // rename never happened, so the real log is intact).
  unlink((w->path + ".tmp").c_str());
  w->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (w->fd < 0) {
    delete w;
    return nullptr;
  }
  if (!wal_scan(w)) {
    close(w->fd);
    delete w;
    return nullptr;
  }
  return w;
}

extern "C" void vrod_wal_close(void* h) {
  Wal* w = (Wal*)h;
  if (w->fd >= 0) close(w->fd);
  delete w;
}

// Returns the assigned lsn, or 0 on error.
extern "C" uint64_t vrod_wal_append(void* h, const uint8_t* data, uint32_t len) {
  Wal* w = (Wal*)h;
  if (w->broken) return 0;
  uint64_t lsn = w->next_lsn;
  uint32_t crc = frame_crc(lsn, len, data);
  std::vector<uint8_t> frame;
  try {
    frame.resize(WAL_HEADER_SIZE + len);
  } catch (const std::bad_alloc&) {
    // bad_alloc must not unwind through the C ABI (std::terminate);
    // 0 is the documented append-failure sentinel.
    return 0;
  }
  memcpy(frame.data(), &WAL_MAGIC, 4);
  memcpy(frame.data() + 4, &lsn, 8);
  memcpy(frame.data() + 12, &len, 4);
  memcpy(frame.data() + 16, &crc, 4);
  if (len) memcpy(frame.data() + WAL_HEADER_SIZE, data, len);
  // Write at valid_size: a previous torn tail (never acked) gets overwritten.
  ssize_t n = pwrite(w->fd, frame.data(), frame.size(), w->valid_size);
  if (n != (ssize_t)frame.size()) return 0;
  WalFrame f;
  f.lsn = lsn;
  f.payload_offset = w->valid_size + WAL_HEADER_SIZE;
  f.payload_len = len;
  w->index.push_back(f);
  w->valid_size += frame.size();
  w->next_lsn = lsn + 1;
  return lsn;
}

extern "C" int vrod_wal_sync(void* h) {
  Wal* w = (Wal*)h;
  return fdatasync(w->fd) == 0 ? 0 : -1;
}

// TRUNCATEWAL semantics (reference: TruncateWalCommand, types.rs:44-54).
extern "C" int vrod_wal_truncate(void* h) {
  Wal* w = (Wal*)h;
  if (ftruncate(w->fd, 0) != 0) return -1;
  if (fdatasync(w->fd) != 0) return -1;
  w->index.clear();
  w->valid_size = 0;
  // next_lsn keeps increasing within this process; across a reopen it is
  // re-seeded from the snapshot's recorded last_lsn (vrod_wal_seed_lsn), so
  // LSNs stay globally monotonic in practice.
  return 0;
}

// Drop every frame with lsn <= upto_lsn, keeping the tail (frames appended
// concurrently with a snapshot). Crash-safe: survivors are written to a
// sibling temp file which is fsynced and renamed over the log.
extern "C" int vrod_wal_truncate_until(void* h, uint64_t upto_lsn) {
  Wal* w = (Wal*)h;
  size_t first_kept = 0;
  while (first_kept < w->index.size() && w->index[first_kept].lsn <= upto_lsn)
    first_kept++;
  if (first_kept == 0) return 0;  // nothing to drop
  if (first_kept == w->index.size()) return vrod_wal_truncate(h);

  std::string tmp_path = w->path + ".tmp";
  int tfd = open(tmp_path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (tfd < 0) return -1;
  uint64_t start = w->index[first_kept].payload_offset - WAL_HEADER_SIZE;
  uint64_t remaining = w->valid_size - start;
  std::vector<uint8_t> buf(1 << 20);
  uint64_t src = start, dst = 0;
  while (remaining > 0) {
    size_t chunk = remaining < buf.size() ? (size_t)remaining : buf.size();
    ssize_t r = pread(w->fd, buf.data(), chunk, src);
    if (r <= 0) { close(tfd); return -1; }
    if (pwrite(tfd, buf.data(), r, dst) != r) { close(tfd); return -1; }
    src += r; dst += r; remaining -= r;
  }
  if (fdatasync(tfd) != 0) { close(tfd); return -1; }
  if (rename(tmp_path.c_str(), w->path.c_str()) != 0) { close(tfd); return -1; }
  // Durable rename: fsync the parent directory.
  std::string dir = w->path;
  size_t slash = dir.find_last_of('/');
  dir = slash == std::string::npos ? std::string(".") : dir.substr(0, slash);
  int dfd = open(dir.c_str(), O_RDONLY);
  if (dfd >= 0) { fsync(dfd); close(dfd); }
  close(w->fd);
  w->fd = tfd;
  uint64_t saved_next = w->next_lsn;
  if (!wal_scan(w)) {
    // The rescan reset index/valid_size; continuing to append would
    // overwrite surviving frames at offset 0 with reused LSNs. Poison the
    // handle: the caller sees the error AND later appends refuse.
    w->broken = true;
    return -1;
  }
  if (w->next_lsn < saved_next) w->next_lsn = saved_next;
  return 0;
}

// Undo appends past `size` (a mutation whose apply failed was never acked).
// next_lsn is NOT rewound: LSNs stay monotonic.
extern "C" int vrod_wal_rewind(void* h, uint64_t size) {
  Wal* w = (Wal*)h;
  if (size > w->valid_size) return -1;
  // size must land on a frame boundary: a mid-frame cut would leave an
  // index entry whose payload reads short on replay.
  if (size != 0 && size != w->valid_size) {
    bool boundary = false;
    for (auto& f : w->index)
      if (f.payload_offset - WAL_HEADER_SIZE == size) { boundary = true; break; }
    if (!boundary) return -1;
  }
  if (ftruncate(w->fd, size) != 0) return -1;
  if (fdatasync(w->fd) != 0) return -1;
  while (!w->index.empty() &&
         w->index.back().payload_offset - WAL_HEADER_SIZE >= size)
    w->index.pop_back();
  w->valid_size = size;
  return 0;
}

// Seed the lsn counter after restore so LSNs stay monotonic across
// truncate+reopen (the snapshot records the lsn it captured).
extern "C" void vrod_wal_seed_lsn(void* h, uint64_t last_lsn) {
  Wal* w = (Wal*)h;
  if (last_lsn + 1 > w->next_lsn) w->next_lsn = last_lsn + 1;
}

// Force the next append's lsn (replication: a replica writes frames with
// the PRIMARY's lsn, including retrying an lsn a rewound local apply
// already consumed from the monotonic counter). Refuses to go at or below
// an indexed frame's lsn — duplicate LSNs in one log are forbidden.
extern "C" int vrod_wal_set_next_lsn(void* h, uint64_t next) {
  Wal* w = (Wal*)h;
  if (!w->index.empty() && next <= w->index.back().lsn) return -1;
  w->next_lsn = next;
  return 0;
}

// Truncate a torn/corrupt tail so the file ends at the last valid frame.
extern "C" int vrod_wal_repair(void* h) {
  Wal* w = (Wal*)h;
  if (ftruncate(w->fd, w->valid_size) != 0) return -1;
  return fdatasync(w->fd) == 0 ? 0 : -1;
}

extern "C" uint64_t vrod_wal_frame_count(void* h) { return ((Wal*)h)->index.size(); }
extern "C" uint64_t vrod_wal_valid_size(void* h) { return ((Wal*)h)->valid_size; }
extern "C" uint64_t vrod_wal_last_lsn(void* h) {
  Wal* w = (Wal*)h;
  return w->index.empty() ? 0 : w->index.back().lsn;
}

// True if the on-disk file extends past the last valid frame (torn tail).
extern "C" int vrod_wal_has_torn_tail(void* h) {
  Wal* w = (Wal*)h;
  off_t file_size = lseek(w->fd, 0, SEEK_END);
  return (uint64_t)file_size > w->valid_size ? 1 : 0;
}

extern "C" uint64_t vrod_wal_frame_len(void* h, uint64_t i) {
  Wal* w = (Wal*)h;
  if (i >= w->index.size()) return 0;
  return w->index[i].payload_len;
}

extern "C" uint64_t vrod_wal_frame_lsn(void* h, uint64_t i) {
  Wal* w = (Wal*)h;
  if (i >= w->index.size()) return 0;
  return w->index[i].lsn;
}

extern "C" long vrod_wal_frame_read(void* h, uint64_t i, uint8_t* buf,
                                    uint64_t buflen) {
  Wal* w = (Wal*)h;
  if (i >= w->index.size()) return -1;
  const WalFrame& f = w->index[i];
  if (buflen < f.payload_len) return -2;
  if (f.payload_len == 0) return 0;
  ssize_t n = pread(w->fd, buf, f.payload_len, f.payload_offset);
  return n == (ssize_t)f.payload_len ? (long)f.payload_len : -3;
}

// ---------------------------------------------------------------------------
// Slot allocator
//
// Backs a collection's HBM tensor: capacity slots, a free list (deleted or
// never-used slots), a live bitmap, and an id<->slot binding. Compaction
// planning pairs live rows in high slots with free low slots so live rows
// pack into [0, live_count) — the device then executes the moves as one
// gather/scatter and the WAL records a REINDEX barrier.
// ---------------------------------------------------------------------------

static const uint64_t NO_ID = UINT64_MAX;

struct Alloc {
  uint64_t capacity = 0;
  uint64_t tail = 0;                    // next never-used slot
  std::vector<uint64_t> free_slots;     // released slots below tail
  std::vector<uint64_t> slot_to_id;     // NO_ID = not live
  std::unordered_map<uint64_t, uint64_t> id_to_slot;
};

extern "C" void* vrod_alloc_new(uint64_t capacity) {
  try {
    Alloc* a = new Alloc();
    a->capacity = capacity;
    a->slot_to_id.assign(capacity, NO_ID);
    return a;
  } catch (const std::bad_alloc&) {
    return nullptr;  // must not unwind through the C ABI
  }
}

extern "C" void vrod_alloc_free(void* h) { delete (Alloc*)h; }

extern "C" int vrod_alloc_grow(void* h, uint64_t new_capacity) {
  Alloc* a = (Alloc*)h;
  if (new_capacity < a->capacity) return -1;
  try {
    a->slot_to_id.resize(new_capacity, NO_ID);
  } catch (const std::bad_alloc&) {
    return -2;  // host OOM; state unchanged (strong guarantee of resize)
  }
  a->capacity = new_capacity;
  return 0;
}

// Shrink after compaction (REINDEX reclaims empty tail segments so the
// scan stops paying for them). Refuses if any live slot >= new_capacity.
extern "C" int vrod_alloc_shrink(void* h, uint64_t new_capacity) {
  Alloc* a = (Alloc*)h;
  if (new_capacity > a->capacity) return -1;
  for (uint64_t s = new_capacity; s < a->tail; s++)
    if (a->slot_to_id[s] != NO_ID) return -2;
  a->slot_to_id.resize(new_capacity);
  a->free_slots.erase(
      std::remove_if(a->free_slots.begin(), a->free_slots.end(),
                     [&](uint64_t s) { return s >= new_capacity; }),
      a->free_slots.end());
  if (a->tail > new_capacity) a->tail = new_capacity;
  a->capacity = new_capacity;
  return 0;
}

extern "C" uint64_t vrod_alloc_capacity(void* h) { return ((Alloc*)h)->capacity; }
extern "C" uint64_t vrod_alloc_live_count(void* h) {
  return ((Alloc*)h)->id_to_slot.size();
}
extern "C" uint64_t vrod_alloc_free_count(void* h) {
  Alloc* a = (Alloc*)h;
  return a->free_slots.size() + (a->capacity - a->tail);
}
// High-water mark: number of leading slots that have ever been used. The
// device search only needs to scan [0, high_water).
extern "C" uint64_t vrod_alloc_high_water(void* h) { return ((Alloc*)h)->tail; }

// Acquire n slots and bind them to ids[0..n). Prefers recycled (free-list)
// slots, then the sequential tail. Returns 0 on success, -1 if capacity is
// insufficient (caller must grow), -2 if an id is already bound.
extern "C" long vrod_alloc_acquire(void* h, uint64_t n, const uint64_t* ids,
                                   uint64_t* slots_out) {
  Alloc* a = (Alloc*)h;
  if (a->free_slots.size() + (a->capacity - a->tail) < n) return -1;
  // Reject collisions with existing bindings AND duplicates within the
  // batch itself (binding one id to two slots would leak a slot and leave
  // a ghost row visible to searches).
  {
    std::unordered_set<uint64_t> batch;
    batch.reserve(n);
    for (uint64_t i = 0; i < n; i++) {
      if (a->id_to_slot.count(ids[i])) return -2;
      if (!batch.insert(ids[i]).second) return -2;
    }
  }
  for (uint64_t i = 0; i < n; i++) {
    uint64_t slot;
    if (!a->free_slots.empty()) {
      slot = a->free_slots.back();
      a->free_slots.pop_back();
    } else {
      slot = a->tail++;
    }
    a->slot_to_id[slot] = ids[i];
    a->id_to_slot[ids[i]] = slot;
    slots_out[i] = slot;
  }
  return 0;
}

// Release the slots bound to ids[0..n) (DELETE). Returns the number released;
// unknown ids are skipped and reported via slots_out[i] = NO_ID.
extern "C" uint64_t vrod_alloc_release(void* h, uint64_t n, const uint64_t* ids,
                                       uint64_t* slots_out) {
  Alloc* a = (Alloc*)h;
  uint64_t released = 0;
  for (uint64_t i = 0; i < n; i++) {
    auto it = a->id_to_slot.find(ids[i]);
    if (it == a->id_to_slot.end()) {
      slots_out[i] = NO_ID;
      continue;
    }
    uint64_t slot = it->second;
    a->slot_to_id[slot] = NO_ID;
    a->free_slots.push_back(slot);
    a->id_to_slot.erase(it);
    slots_out[i] = slot;
    released++;
  }
  return released;
}

extern "C" uint64_t vrod_alloc_slot_of(void* h, uint64_t id) {
  Alloc* a = (Alloc*)h;
  auto it = a->id_to_slot.find(id);
  return it == a->id_to_slot.end() ? NO_ID : it->second;
}

extern "C" uint64_t vrod_alloc_id_of(void* h, uint64_t slot) {
  Alloc* a = (Alloc*)h;
  if (slot >= a->capacity) return NO_ID;
  return a->slot_to_id[slot];
}

// Bulk slot->id mapping (one call for a whole result batch). Slots out of
// range or unbound map to NO_ID.
extern "C" void vrod_alloc_ids_of(void* h, uint64_t n, const uint64_t* slots,
                                  uint64_t* out) {
  Alloc* a = (Alloc*)h;
  for (uint64_t i = 0; i < n; i++)
    out[i] = slots[i] < a->capacity ? a->slot_to_id[slots[i]] : NO_ID;
}

// Bulk id->slot mapping (filtered search builds slot masks from id lists).
// Unknown ids map to NO_ID.
extern "C" void vrod_alloc_slots_of(void* h, uint64_t n, const uint64_t* ids,
                                    uint64_t* out) {
  Alloc* a = (Alloc*)h;
  for (uint64_t i = 0; i < n; i++) {
    auto it = a->id_to_slot.find(ids[i]);
    out[i] = it == a->id_to_slot.end() ? NO_ID : it->second;
  }
}

extern "C" int vrod_alloc_is_live(void* h, uint64_t slot) {
  Alloc* a = (Alloc*)h;
  return (slot < a->capacity && a->slot_to_id[slot] != NO_ID) ? 1 : 0;
}

// Fill out[0..live_count) with the live slots in ascending order.
extern "C" uint64_t vrod_alloc_live_slots(void* h, uint64_t* out) {
  Alloc* a = (Alloc*)h;
  uint64_t n = 0;
  for (uint64_t s = 0; s < a->tail; s++)
    if (a->slot_to_id[s] != NO_ID) out[n++] = s;
  return n;
}

// Plan a compaction: pair live slots >= live_count with free slots <
// live_count. Writes (src, dst) pairs; returns the number of moves. Does NOT
// mutate state — call vrod_alloc_apply_compaction after the device executes
// the moves.
extern "C" uint64_t vrod_alloc_plan_compaction(void* h, uint64_t* src_out,
                                               uint64_t* dst_out) {
  Alloc* a = (Alloc*)h;
  uint64_t live = a->id_to_slot.size();
  std::vector<uint64_t> holes;
  for (uint64_t s = 0; s < live; s++)
    if (a->slot_to_id[s] == NO_ID) holes.push_back(s);
  uint64_t n = 0;
  uint64_t hole_i = 0;
  for (uint64_t s = a->tail; s-- > live;) {
    if (a->slot_to_id[s] == NO_ID) continue;
    src_out[n] = s;
    dst_out[n] = holes[hole_i++];
    n++;
  }
  return n;
}

extern "C" int vrod_alloc_apply_compaction(void* h, uint64_t n,
                                           const uint64_t* src,
                                           const uint64_t* dst) {
  Alloc* a = (Alloc*)h;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t id = a->slot_to_id[src[i]];
    if (id == NO_ID || a->slot_to_id[dst[i]] != NO_ID) return -1;
    a->slot_to_id[dst[i]] = id;
    a->slot_to_id[src[i]] = NO_ID;
    a->id_to_slot[id] = dst[i];
  }
  // After compaction live rows occupy [0, live); reset tail and free list.
  uint64_t live = a->id_to_slot.size();
  a->tail = live;
  a->free_slots.clear();
  return 0;
}
