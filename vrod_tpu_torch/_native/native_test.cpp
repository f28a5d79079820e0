// Native-layer self-test: exercises the WAL and slot allocator directly in
// C++ (no Python in the loop). Built and run by tests/test_torch_native_cpp.py;
// exits 0 on success, prints the failing check and exits 1 otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
uint32_t vrod_crc32(const uint8_t*, uint64_t);
void* vrod_wal_open(const char*);
void vrod_wal_close(void*);
uint64_t vrod_wal_append(void*, const uint8_t*, uint32_t);
int vrod_wal_sync(void*);
int vrod_wal_truncate(void*);
int vrod_wal_repair(void*);
uint64_t vrod_wal_frame_count(void*);
uint64_t vrod_wal_valid_size(void*);
uint64_t vrod_wal_last_lsn(void*);
int vrod_wal_has_torn_tail(void*);
uint64_t vrod_wal_frame_len(void*, uint64_t);
uint64_t vrod_wal_frame_lsn(void*, uint64_t);
long vrod_wal_frame_read(void*, uint64_t, uint8_t*, uint64_t);

void* vrod_alloc_new(uint64_t);
void vrod_alloc_free(void*);
int vrod_alloc_grow(void*, uint64_t);
uint64_t vrod_alloc_capacity(void*);
uint64_t vrod_alloc_live_count(void*);
uint64_t vrod_alloc_free_count(void*);
uint64_t vrod_alloc_high_water(void*);
long vrod_alloc_acquire(void*, uint64_t, const uint64_t*, uint64_t*);
uint64_t vrod_alloc_release(void*, uint64_t, const uint64_t*, uint64_t*);
uint64_t vrod_alloc_slot_of(void*, uint64_t);
uint64_t vrod_alloc_id_of(void*, uint64_t);
int vrod_alloc_is_live(void*, uint64_t);
uint64_t vrod_alloc_live_slots(void*, uint64_t*);
uint64_t vrod_alloc_plan_compaction(void*, uint64_t*, uint64_t*);
int vrod_alloc_apply_compaction(void*, uint64_t, const uint64_t*,
                                const uint64_t*);
}

static int failures = 0;
#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);  \
      failures++;                                                      \
    }                                                                  \
  } while (0)

static void test_crc32() {
  // zlib-compatible vector: crc32("123456789") == 0xCBF43926
  const char* s = "123456789";
  CHECK(vrod_crc32((const uint8_t*)s, 9) == 0xCBF43926u);
  CHECK(vrod_crc32(nullptr, 0) == 0u);
}

static void test_wal(const std::string& dir) {
  std::string path = dir + "/vr_wal_selftest";
  remove(path.c_str());
  void* w = vrod_wal_open(path.c_str());
  CHECK(w != nullptr);
  const uint8_t a[] = "alpha";
  const uint8_t b[] = "bravo!";
  CHECK(vrod_wal_append(w, a, 5) == 1);
  CHECK(vrod_wal_append(w, b, 6) == 2);
  CHECK(vrod_wal_sync(w) == 0);
  CHECK(vrod_wal_frame_count(w) == 2);
  CHECK(vrod_wal_last_lsn(w) == 2);
  uint8_t buf[16];
  CHECK(vrod_wal_frame_read(w, 0, buf, 16) == 5);
  CHECK(memcmp(buf, "alpha", 5) == 0);
  CHECK(vrod_wal_frame_lsn(w, 1) == 2);
  uint64_t valid = vrod_wal_valid_size(w);
  vrod_wal_close(w);

  // Torn tail: write garbage after the valid frames.
  FILE* f = fopen(path.c_str(), "ab");
  fwrite("WL_1garbage", 1, 11, f);
  fclose(f);
  w = vrod_wal_open(path.c_str());
  CHECK(vrod_wal_frame_count(w) == 2);
  CHECK(vrod_wal_has_torn_tail(w) == 1);
  CHECK(vrod_wal_repair(w) == 0);
  CHECK(vrod_wal_has_torn_tail(w) == 0);
  CHECK(vrod_wal_valid_size(w) == valid);
  // Append after repair keeps the lsn sequence.
  CHECK(vrod_wal_append(w, a, 5) == 3);
  // Truncate drops frames but lsn keeps rising.
  CHECK(vrod_wal_truncate(w) == 0);
  CHECK(vrod_wal_frame_count(w) == 0);
  CHECK(vrod_wal_append(w, b, 6) == 4);
  vrod_wal_close(w);
  remove(path.c_str());
}

static void test_alloc() {
  void* h = vrod_alloc_new(8);
  uint64_t ids[4] = {100, 101, 102, 103};
  uint64_t slots[4];
  CHECK(vrod_alloc_acquire(h, 4, ids, slots) == 0);
  CHECK(vrod_alloc_live_count(h) == 4);
  CHECK(vrod_alloc_high_water(h) == 4);
  CHECK(vrod_alloc_slot_of(h, 101) == slots[1]);
  CHECK(vrod_alloc_id_of(h, slots[2]) == 102);
  // duplicate id rejected
  CHECK(vrod_alloc_acquire(h, 1, ids, slots) == -2);
  // release + recycle
  uint64_t rid = 101, out;
  CHECK(vrod_alloc_release(h, 1, &rid, &out) == 1);
  CHECK(out == 1);
  uint64_t nid = 200;
  CHECK(vrod_alloc_acquire(h, 1, &nid, &out) == 0);
  CHECK(out == 1);  // freed slot reused before the tail
  CHECK(vrod_alloc_high_water(h) == 4);
  // capacity exhaustion then grow
  uint64_t more[5] = {300, 301, 302, 303, 304};
  uint64_t mslots[5];
  CHECK(vrod_alloc_acquire(h, 5, more, mslots) == -1);
  CHECK(vrod_alloc_grow(h, 16) == 0);
  CHECK(vrod_alloc_acquire(h, 5, more, mslots) == 0);
  // compaction: delete a low slot, plan must pack into [0, live)
  uint64_t del = 100, dout;
  vrod_alloc_release(h, 1, &del, &dout);
  uint64_t src[16], dst[16];
  uint64_t moves = vrod_alloc_plan_compaction(h, src, dst);
  uint64_t live = vrod_alloc_live_count(h);
  for (uint64_t i = 0; i < moves; i++) {
    CHECK(src[i] >= live);
    CHECK(dst[i] < live);
  }
  CHECK(vrod_alloc_apply_compaction(h, moves, src, dst) == 0);
  CHECK(vrod_alloc_high_water(h) == live);
  std::vector<uint64_t> ls(live);
  CHECK(vrod_alloc_live_slots(h, ls.data()) == live);
  for (uint64_t i = 0; i < live; i++) CHECK(ls[i] == i);
  vrod_alloc_free(h);
}

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : ".";
  test_crc32();
  test_wal(dir);
  test_alloc();
  if (failures) {
    fprintf(stderr, "%d checks failed\n", failures);
    return 1;
  }
  printf("native self-test OK\n");
  return 0;
}
