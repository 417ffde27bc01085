// Native windowed-minmer scanner for the target index.
//
// C++ implementation of the event machine specified (and oracle-tested) in
// wfmash_tpu/sketch/winnow.py — the host-side reference-index scan, the one
// part of the pipeline that is inherently a sequential per-base sweep and
// belongs on the CPU. Exposed via a plain C ABI consumed with ctypes.
//
// Semantics match CommonFunc::addMinmers (reference:
// src/map/include/commonFunc.hpp:439-708) as re-derived in winnow.py,
// including the lazy ambig counter (no initial in-k-mer N scan), the
// single-expiry-per-step rule, strand-vote record splits, the strict
// pos > currentWindowId eviction push-back, chunking and consecutive
// (wpos, hash) dedup.
//
// Also exports a standalone batch k-mer hasher (canonical murmur3 low-64)
// used by the host pipeline.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <queue>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MurmurHash3_x64_128 low 64 bits (public-domain algorithm, Austin Appleby)
// ---------------------------------------------------------------------------

inline uint64_t rotl64(uint64_t x, int8_t r) {
    return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

uint64_t murmur3_low64(const uint8_t* data, int len, uint32_t seed) {
    const int nblocks = len / 16;
    uint64_t h1 = seed, h2 = seed;
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;

    for (int i = 0; i < nblocks; i++) {
        uint64_t k1, k2;
        std::memcpy(&k1, data + i * 16, 8);
        std::memcpy(&k2, data + i * 16 + 8, 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }

    const uint8_t* tail = data + nblocks * 16;
    uint64_t k1 = 0, k2 = 0;
    switch (len & 15) {
        case 15: k2 ^= (uint64_t)tail[14] << 48; [[fallthrough]];
        case 14: k2 ^= (uint64_t)tail[13] << 40; [[fallthrough]];
        case 13: k2 ^= (uint64_t)tail[12] << 32; [[fallthrough]];
        case 12: k2 ^= (uint64_t)tail[11] << 24; [[fallthrough]];
        case 11: k2 ^= (uint64_t)tail[10] << 16; [[fallthrough]];
        case 10: k2 ^= (uint64_t)tail[9] << 8; [[fallthrough]];
        case 9:
            k2 ^= (uint64_t)tail[8];
            k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
            [[fallthrough]];
        case 8: k1 ^= (uint64_t)tail[7] << 56; [[fallthrough]];
        case 7: k1 ^= (uint64_t)tail[6] << 48; [[fallthrough]];
        case 6: k1 ^= (uint64_t)tail[5] << 40; [[fallthrough]];
        case 5: k1 ^= (uint64_t)tail[4] << 32; [[fallthrough]];
        case 4: k1 ^= (uint64_t)tail[3] << 24; [[fallthrough]];
        case 3: k1 ^= (uint64_t)tail[2] << 16; [[fallthrough]];
        case 2: k1 ^= (uint64_t)tail[1] << 8; [[fallthrough]];
        case 1:
            k1 ^= (uint64_t)tail[0];
            k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }

    h1 ^= (uint64_t)len;
    h2 ^= (uint64_t)len;
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    h1 += h2;
    return h1;
}

// normalization: uppercase then non-ACGT -> 'N'; complement: ACGT<->TGCA
struct Tables {
    uint8_t norm[256];
    uint8_t comp[256];
    Tables() {
        for (int i = 0; i < 256; i++) {
            int c = (i >= 'a' && i <= 'z') ? i - 32 : i;
            norm[i] = (c == 'A' || c == 'C' || c == 'G' || c == 'T')
                          ? (uint8_t)c : (uint8_t)'N';
            comp[i] = (uint8_t)i;
        }
        comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
    }
};
const Tables T;

struct Record {
    uint64_t hash;
    int64_t wpos;
    int64_t wend;
    int32_t seq_id;
    int8_t strand;
};

struct Occ {
    int64_t pos;
    int8_t vote;
};

struct Entry {
    int64_t wpos;
    int32_t strand;
    std::deque<Occ> poslist;
};

// The backlog holds up to one item a k-mer of the sequence (an expired
// item leaves only when it surfaces), so its item's width is the scan's
// memory: pos and vote in one word, pos << 1 | (vote > 0), 16 bytes an
// item. Ordered as (hash, pos) as before, since one position has one vote.
struct HeapItem {
    uint64_t hash;
    uint64_t pv;
    HeapItem(uint64_t h, int64_t p, int8_t v)
        : hash(h), pv((uint64_t)(p * 2 + (v > 0 ? 1 : 0))) {}
    int64_t pos() const { return (int64_t)(pv >> 1); }
    int8_t vote() const { return (pv & 1) ? 1 : -1; }
    bool operator>(const HeapItem& o) const {
        return hash != o.hash ? hash > o.hash : pv > o.pv;
    }
};

// on a deque: it grows by blocks, never by copying itself to twice its
// size; the heap's operations and so its order are a vector's
using MinHeap = std::priority_queue<HeapItem, std::deque<HeapItem>,
                                    std::greater<HeapItem>>;

// k-mers hashed a block: the per-position arrays live one block at a
// time, not the sequence's length
const int64_t HASH_BLOCK = 1 << 20;

// canonical_hashes' outputs for the k-mers at positions [i0, i1) of a raw
// sequence (the k-mer at i is seq[i, i + k)), normalized on the fly into
// s (scratch of i1 - i0 + k - 1 bytes). `ambig`, the winnow-style lazy
// counter, carries from position i0 - 1 (0 before position 0), so blocks
// taken in order give the whole sequence's arrays.
void hash_block(const uint8_t* seq, int64_t i0, int64_t i1, int k,
                uint8_t* s, uint64_t* canon, int8_t* vote,
                uint8_t* valid_sketch, uint8_t* valid_winnow, int& ambig) {
    const int64_t m = i1 - i0 + k - 1;
    for (int64_t j = 0; j < m; j++) s[j] = T.norm[seq[i0 + j]];
    std::vector<uint8_t> rc(k);
    int nwin = 0;  // 'N's in s[j, j + k - 1) before step j
    for (int j = 0; j < k - 1; j++) nwin += s[j] == 'N';
    for (int64_t j = 0; j < i1 - i0; j++) {
        nwin += s[j + k - 1] == 'N';
        uint64_t fwd = murmur3_low64(&s[j], k, 42);
        for (int t = 0; t < k; t++) rc[k - 1 - t] = T.comp[s[j + t]];
        uint64_t bwd = murmur3_low64(rc.data(), k, 42);
        canon[j] = fwd < bwd ? fwd : bwd;
        vote[j] = fwd < bwd ? 1 : -1;
        // sketch-style validity: no 'N' anywhere in the window
        valid_sketch[j] = (fwd != bwd && nwin == 0) ? 1 : 0;
        if (s[j + k - 1] == 'N') ambig = k;
        valid_winnow[j] = (fwd != bwd && ambig == 0) ? 1 : 0;
        if (ambig > 0) ambig--;
        nwin -= s[j] == 'N';
    }
}

// The windowed scan over the n k-mers of a raw sequence: its records,
// unsorted, into `records` (winnow_scan's first part).
void scan(const uint8_t* seq, int64_t n, int k, int window_size,
          int sketch_size, int32_t seq_id, std::vector<Record>& records) {
    // the k-mers' hashes, a block at a time (b0: the block's first)
    const int64_t nb = std::min(n, HASH_BLOCK);
    std::vector<uint64_t> canon(nb);
    std::vector<int8_t> vote(nb);
    std::vector<uint8_t> s(nb + k - 1), vs(nb), vw(nb);
    int64_t b0 = 0, b1 = 0;
    int ambig = 0;

    std::deque<HeapItem> q;      // arrival queue of valid kmers
    std::map<uint64_t, Entry> sw;    // the sketch (ordered)
    MinHeap heap;                // backlog

    for (int64_t i = 0; i < n; i++) {
        int64_t W = i + k - window_size;
        if (i == b1) {
            b0 = i;
            b1 = std::min(n, i + HASH_BLOCK);
            hash_block(seq, b0, b1, k, s.data(), canon.data(), vote.data(),
                       vs.data(), vw.data(), ambig);
        }

        // expiry (at most one per step)
        if (!q.empty() && q.front().pos() < W) {
            HeapItem leaving = q.front();
            q.pop_front();
            if (!sw.empty() && leaving.hash <= sw.rbegin()->first) {
                auto it = sw.find(leaving.hash);
                Entry& e = it->second;
                if (e.poslist.size() == 1) {
                    records.push_back(
                        {leaving.hash, e.wpos, W, seq_id,
                         (int8_t)(e.strand < 0 ? -1 : 1)});
                    sw.erase(it);
                } else {
                    if (e.strand - leaving.vote() == 0 || e.strand == 0) {
                        records.push_back(
                            {leaving.hash, e.wpos, W, seq_id,
                             (int8_t)(e.strand < 0 ? -1 : 1)});
                        e.wpos = W;
                    }
                    e.strand -= leaving.vote();
                    e.poslist.pop_front();
                }
            }
        }

        // arrival
        if (vw[i - b0]) {
            HeapItem item(canon[i - b0], i, vote[i - b0]);
            q.push_back(item);
            auto it = sw.find(item.hash);
            if (it != sw.end()) {
                Entry& e = it->second;
                e.poslist.push_back({i, item.vote()});
                if (e.strand + item.vote() == 0 || e.strand == 0) {
                    records.push_back({item.hash, e.wpos, W, seq_id,
                                       (int8_t)(e.strand < 0 ? -1 : 1)});
                    e.wpos = W;
                }
                e.strand += item.vote();
            } else {
                heap.push(item);
            }
        }

        // sketch maintenance
        if (W >= 0) {
            while (!heap.empty() && heap.top().pos() < W) heap.pop();

            if (!sw.empty() && !heap.empty() &&
                (int)sw.size() == sketch_size &&
                heap.top().hash < sw.rbegin()->first) {
                auto it = std::prev(sw.end());
                Entry& e = it->second;
                records.push_back({it->first, e.wpos, W, seq_id,
                                   (int8_t)(e.strand < 0 ? -1 : 1)});
                for (const Occ& o : e.poslist) {
                    if (o.pos > W)
                        heap.push(HeapItem(it->first, o.pos, o.vote));
                }
                sw.erase(it);
            }

            while (!heap.empty() && (int)sw.size() < sketch_size) {
                if (heap.top().pos() < W) {
                    heap.pop();
                    if (heap.empty()) break;
                }
                uint64_t nh = heap.top().hash;
                Entry& e = sw[nh];
                e.wpos = W;
                e.strand = 0;
                while (!heap.empty() && heap.top().hash == nh) {
                    e.poslist.push_back({heap.top().pos(), heap.top().vote()});
                    e.strand += heap.top().vote();
                    heap.pop();
                }
            }
        }
    }

    // flush open records
    for (auto& [h, e] : sw) {
        records.push_back({h, e.wpos, n, seq_id,
                           (int8_t)(e.strand < 0 ? -1 : 1)});
    }
}

}  // namespace

extern "C" {

// Canonical k-mer hashes of a normalized sequence. Outputs per position:
// canon[i] (uint64), vote[i] (+1/-1), valid_sketch[i] (no-N window,
// non-palindromic), valid_winnow[i] (lazy-ambig variant). Returns n kmers.
int64_t canonical_hashes(const uint8_t* seq, int64_t len, int k,
                         uint64_t* canon, int8_t* vote,
                         uint8_t* valid_sketch, uint8_t* valid_winnow) {
    int64_t n = len - k + 1;
    if (n <= 0) return 0;
    std::vector<uint8_t> s(std::min(n, HASH_BLOCK) + k - 1);
    int ambig = 0;
    for (int64_t i0 = 0; i0 < n; i0 += HASH_BLOCK) {
        int64_t i1 = std::min(n, i0 + HASH_BLOCK);
        hash_block(seq, i0, i1, k, s.data(), canon + i0, vote + i0,
                   valid_sketch + i0, valid_winnow + i0, ambig);
    }
    return n;
}

// Windowed minmer scan. Returns number of records; fills *out (caller
// frees with free_records). seq is RAW (normalization done internally).
int64_t winnow_scan(const uint8_t* seq, int64_t len, int k, int window_size,
                    int sketch_size, int32_t seq_id, Record** out) {
    *out = nullptr;
    int64_t n = len - k + 1;
    if (n <= 0) return 0;

    std::vector<Record> records;
    scan(seq, n, k, window_size, sketch_size, seq_id, records);

    // drop empty/invalid, chunk long intervals (chunks appended after)
    std::vector<Record> kept, chunks;
    for (const Record& r : records) {
        if (r.wpos < 0 || r.wend < 0 || r.wpos == r.wend) continue;
        if (r.wend > r.wpos + window_size) {
            for (int64_t c = r.wpos; c < r.wend; c += window_size) {
                chunks.push_back({r.hash, c,
                                  std::min(c + window_size, r.wend), seq_id,
                                  r.strand});
            }
        } else {
            kept.push_back(r);
        }
    }
    std::vector<Record>().swap(records);
    kept.insert(kept.end(), chunks.begin(), chunks.end());
    std::vector<Record>().swap(chunks);

    std::stable_sort(kept.begin(), kept.end(),
                     [](const Record& a, const Record& b) {
                         return a.wpos != b.wpos ? a.wpos < b.wpos
                                                 : a.wend < b.wend;
                     });
    // consecutive (wpos, hash) dedup
    std::vector<Record> final_recs;
    final_recs.reserve(kept.size());
    for (const Record& r : kept) {
        if (!final_recs.empty() && final_recs.back().wpos == r.wpos &&
            final_recs.back().hash == r.hash)
            continue;
        final_recs.push_back(r);
    }
    std::vector<Record>().swap(kept);

    Record* buf = (Record*)std::malloc(final_recs.size() * sizeof(Record));
    std::memcpy(buf, final_recs.data(), final_recs.size() * sizeof(Record));
    *out = buf;
    return (int64_t)final_recs.size();
}

void free_records(Record* r) { std::free(r); }

// Bottom-s fragment sketches for a WHOLE query in one call
// (sketch/minhash.py::sketch_fragment is the Python spec —
// bit-identical, tested; fragments are the mapper's w-length windows
// plus the w-length tail window, computeMap.hpp:560-631).
//
// Outputs concatenate per fragment (out_counts[f] entries each):
// hashes ascending, first/last occurrence positions, strand votes'
// signs; out_complexity[f] is the k-mer complexity estimate. Caller
// provides n_frag*s capacity (n_frag = len/w + tail). Returns the
// fragment count.
int64_t sketch_fragments(const uint8_t* seq, int64_t len, int k,
                         int64_t w, int64_t s, uint64_t* out_hashes,
                         int64_t* out_wpos, int64_t* out_wend,
                         int8_t* out_strand, int64_t* out_counts,
                         double* out_complexity) {
    const int64_t n_main = len / w;
    const bool tail = n_main >= 1 && (len % w) != 0;
    const int64_t n_frag = n_main + (tail ? 1 : 0);
    const int64_t nk = w - k + 1;
    std::vector<uint64_t> canon(std::max<int64_t>(nk, 1));
    std::vector<int8_t> vote(std::max<int64_t>(nk, 1));
    std::vector<uint8_t> vs(std::max<int64_t>(nk, 1)),
        vw(std::max<int64_t>(nk, 1));
    struct HP { uint64_t h; int64_t pos; int8_t v; };
    std::vector<HP> ent;
    int64_t out_off = 0;
    for (int64_t f = 0; f < n_frag; f++) {
        const int64_t start = (f < n_main) ? f * w : len - w;
        out_counts[f] = 0;
        out_complexity[f] = 0.0;
        if (nk <= 0) continue;
        canonical_hashes(seq + start, w, k, canon.data(), vote.data(),
                         vs.data(), vw.data());
        ent.clear();
        for (int64_t i = 0; i < nk; i++)
            if (vs[i]) ent.push_back({canon[i], i, vote[i]});
        if (ent.empty()) continue;
        std::sort(ent.begin(), ent.end(), [](const HP& a, const HP& b) {
            return a.h != b.h ? a.h < b.h : a.pos < b.pos;
        });
        int64_t kept = 0;
        uint64_t last_hash = 0;
        size_t i = 0;
        while (i < ent.size() && kept < s) {
            size_t j = i;
            int64_t vsum = 0;
            int64_t first = ent[i].pos, last_p = ent[i].pos;
            while (j < ent.size() && ent[j].h == ent[i].h) {
                vsum += ent[j].v;
                if (ent[j].pos > last_p) last_p = ent[j].pos;
                j++;
            }
            out_hashes[out_off + kept] = ent[i].h;
            out_wpos[out_off + kept] = first;
            out_wend[out_off + kept] = last_p;
            out_strand[out_off + kept] =
                vsum > 0 ? 1 : (vsum < 0 ? -1 : 0);
            last_hash = ent[i].h;
            kept++;
            i = j;
        }
        out_counts[f] = kept;
        const double U64F = 18446744073709551615.0;
        double max01 = (double)last_hash / U64F;
        out_complexity[f] =
            max01 > 0 ? ((double)kept / max01) / ((double)nk * 2.0)
                      : 0.0;
        out_off += kept;
    }
    return n_frag;
}

}  // extern "C"
