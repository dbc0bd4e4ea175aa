// Native k-mer count aggregator: open-addressing hash map, 42-bit keys.
//
// The host-side merge sink for device-produced (key, count) batches
// (ops/kmer.py: unique_counts_batch). A Python dict costs ~100ns+/op and
// GC pressure at WGS scale (billions of k-mers); this store is a flat
// linear-probing table with power-of-two sizing and automatic growth.
//
// Keys are the (hi, lo) int32 pairs packed to a single u64: (hi << 21) | lo
// for k=21 (hi holds 11 bases = 22 bits, lo 10 bases = 20 bits); generically
// key = (u64)hi << 32 | (u32)lo, which is unique for any k <= 31.
//
// C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Slot {
  uint64_t key;
  uint64_t count;  // count==0 marks an empty slot (keys are stored
                   // verbatim; key 0 is protected by the count flag)
};

struct Store {
  std::vector<Slot> slots;
  uint64_t size = 0;  // occupied slots
  uint64_t mask = 0;

  explicit Store(uint64_t cap_pow2) {
    uint64_t cap = 1;
    while (cap < cap_pow2) cap <<= 1;
    slots.assign(cap, Slot{0, 0});
    mask = cap - 1;
  }

  static uint64_t hash(uint64_t k) {
    // splitmix64 finalizer
    k ^= k >> 30;
    k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27;
    k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return k;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{0, 0});
    mask = slots.size() - 1;
    size = 0;
    for (const Slot& s : old) {
      if (s.count != 0) add(s.key, s.count);
    }
  }

  void add(uint64_t key, uint64_t count) {
    if ((size + 1) * 4 > slots.size() * 3) grow();  // load factor 0.75
    uint64_t i = hash(key) & mask;
    while (true) {
      Slot& s = slots[i];
      if (s.count == 0) {
        s.key = key;
        s.count = count;
        ++size;
        return;
      }
      if (s.key == key) {
        s.count += count;
        return;
      }
      i = (i + 1) & mask;
    }
  }

  uint64_t get(uint64_t key) const {
    uint64_t i = hash(key) & mask;
    while (true) {
      const Slot& s = slots[i];
      if (s.count == 0) return 0;
      if (s.key == key) return s.count;
      i = (i + 1) & mask;
    }
  }
};

inline uint64_t pack_key(int32_t hi, int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
         static_cast<uint32_t>(lo);
}

}  // namespace

extern "C" {

void* ks_new(uint64_t initial_capacity) {
  return new Store(initial_capacity < 16 ? 16 : initial_capacity);
}

void ks_free(void* h) { delete static_cast<Store*>(h); }

// Merge a device batch: counts[i] == 0 entries are skipped (padding).
void ks_merge(void* h, const int32_t* key_hi, const int32_t* key_lo,
              const int32_t* counts, int64_t n) {
  auto* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (counts[i] > 0) {
      s->add(pack_key(key_hi[i], key_lo[i]), static_cast<uint64_t>(counts[i]));
    }
  }
}

uint64_t ks_size(void* h) { return static_cast<Store*>(h)->size; }

uint64_t ks_total(void* h) {
  auto* s = static_cast<Store*>(h);
  uint64_t t = 0;
  for (const Slot& sl : s->slots) t += sl.count;
  return t;
}

uint64_t ks_get(void* h, int32_t hi, int32_t lo) {
  return static_cast<Store*>(h)->get(pack_key(hi, lo));
}

// Dump up to cap entries; returns number written.
uint64_t ks_dump(void* h, int32_t* out_hi, int32_t* out_lo, uint64_t* out_counts,
                 uint64_t cap) {
  auto* s = static_cast<Store*>(h);
  uint64_t w = 0;
  for (const Slot& sl : s->slots) {
    if (sl.count != 0) {
      if (w >= cap) break;
      out_hi[w] = static_cast<int32_t>(sl.key >> 32);
      out_lo[w] = static_cast<int32_t>(sl.key & 0xffffffffULL);
      out_counts[w] = sl.count;
      ++w;
    }
  }
  return w;
}

// Single-pass decoder for the drain's delta byte planes (the inverse of
// ops/kmer.py:_plane_pack, same contract as _decode_planes_np): planes is
// (kp+cp) rows of b bytes; entry i's delta is the little-endian kp-byte
// integer planes[p*b+i], accumulated mod 2^64 from key0_biased (the first
// key pre-mapped into the biased tight embedding: key = (hi^2^31)*2^s +
// lo). Counts come from the cp trailing planes, or are all 1 when cp == 0.
// One pass instead of numpy's per-plane column copies.
void ks_decode_planes(const uint8_t* planes, int64_t b, int64_t m,
                      int32_t kp, int32_t cp, uint64_t key0_biased,
                      int32_t s, int32_t* out_hi, int32_t* out_lo,
                      int64_t* out_ct) {
  const uint64_t lo_mask =
      (s >= 64) ? ~0ULL : ((1ULL << s) - 1ULL);
  uint64_t key = key0_biased;  // element 0's wire delta is 0
  for (int64_t i = 0; i < m; ++i) {
    uint64_t delta = 0;
    for (int32_t p = 0; p < kp; ++p)
      delta |= static_cast<uint64_t>(planes[static_cast<uint64_t>(p) * b + i])
               << (8 * p);
    key += delta;  // wraps mod 2^64 by construction
    out_hi[i] = static_cast<int32_t>(
        static_cast<uint32_t>(key >> s) ^ 0x80000000u);
    out_lo[i] = static_cast<int32_t>(key & lo_mask);
    if (cp == 0) {
      out_ct[i] = 1;
    } else {
      uint64_t c = 0;
      for (int32_t p = 0; p < cp; ++p)
        c |= static_cast<uint64_t>(
                 planes[static_cast<uint64_t>(kp + p) * b + i])
             << (8 * p);
      out_ct[i] = static_cast<int64_t>(c);
    }
  }
}

}  // extern "C"
