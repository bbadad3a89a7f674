// Read-only LMDB (data.mdb) reader: mmap + B+tree lookup, no liblmdb.
//
// The reference reads per-frame TSN features from an LMDB database via
// lmdbdict (hoi_forecast/dataset/epic_structures.py; lmdb keys like
// "P24/rgb_frames/P24_05/frame_0000075700.jpg"). Where neither liblmdb nor
// the python lmdb package is installed, this implements the on-disk format
// directly (layout per upstream mdb.c: MDB_page header 16
// bytes, MDB_meta at page offset 16 with psize in mm_dbs[0].md_pad, main DB
// in mm_dbs[1], 2-byte node offsets growing from pb_lower, nodes packed
// downward from pb_upper, F_BIGDATA values on contiguous overflow pages).
//
// Scope: read-only, default comparator (memcmp, shorter-is-less), main DB
// only. DUPSORT/named sub-DBs are rejected (the feature DB uses neither).
//
// Exports (C ABI, used via ctypes from handsonvlm_torch/data/native_lmdb.py):
//   void*  lmdb_open(const char* path)            // file or dir (data.mdb)
//   void   lmdb_close(void*)
//   int64  lmdb_entries(void*)                    // md_entries of main DB
//   int    lmdb_get(void*, key, klen, &val, &vlen)  // 0 hit, -1 miss, <-1 err
//   void*  lmdb_cursor_open(void*)
//   int    lmdb_cursor_next(void*, &key,&klen, &val,&vlen) // 0 ok, -1 end
//   void   lmdb_cursor_close(void*)

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t MDB_MAGIC = 0xBEEFC0DE;
constexpr uint16_t P_BRANCH = 0x01, P_LEAF = 0x02, P_OVERFLOW = 0x04,
                   P_META = 0x08, P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01, F_SUBDATA = 0x02, F_DUPDATA = 0x04;
constexpr size_t PAGEHDRSZ = 16;

inline uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

struct Db {
    const uint8_t* map = nullptr;
    size_t map_size = 0;
    uint32_t psize = 0;
    uint16_t depth = 0;
    uint64_t root = ~0ull;
    uint64_t entries = 0;
    int fd = -1;

    const uint8_t* page(uint64_t pgno) const {
        size_t off = (size_t)pgno * psize;
        return (off + PAGEHDRSZ <= map_size) ? map + off : nullptr;
    }
};

struct Node {
    const uint8_t* p;
    uint16_t lo() const { return rd16(p); }
    uint16_t hi() const { return rd16(p + 2); }
    uint16_t flags() const { return rd16(p + 4); }
    uint16_t ksize() const { return rd16(p + 6); }
    const uint8_t* key() const { return p + 8; }
    uint32_t dsize() const { return (uint32_t)lo() | ((uint32_t)hi() << 16); }
    // branch child pgno: lo | hi<<16 | flags<<32 (NODEPGNO, 64-bit build)
    uint64_t pgno() const {
        return (uint64_t)lo() | ((uint64_t)hi() << 16) | ((uint64_t)flags() << 32);
    }
};

inline uint16_t numkeys(const uint8_t* pg) {
    uint16_t lower = rd16(pg + 12);
    return lower < PAGEHDRSZ ? 0 : (uint16_t)((lower - PAGEHDRSZ) >> 1);
}
inline Node node_at(const uint8_t* pg, uint16_t i) {
    return Node{pg + rd16(pg + PAGEHDRSZ + 2 * (size_t)i)};
}
inline uint16_t page_flags(const uint8_t* pg) { return rd16(pg + 10); }

// default LMDB comparator: memcmp over min length, then length
int cmp_keys(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
    size_t n = alen < blen ? alen : blen;
    int c = n ? std::memcmp(a, b, n) : 0;
    if (c) return c;
    return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

// leaf node value, following F_BIGDATA overflow chains
int node_value(const Db& db, Node n, const uint8_t** val, size_t* vlen) {
    if (n.flags() & (F_SUBDATA | F_DUPDATA)) return -3;  // unsupported
    uint32_t sz = n.dsize();
    if (n.flags() & F_BIGDATA) {
        uint64_t opg = rd64(n.key() + n.ksize());
        const uint8_t* pg = db.page(opg);
        if (!pg || !(page_flags(pg) & P_OVERFLOW)) return -4;
        if ((size_t)(pg - db.map) + PAGEHDRSZ + sz > db.map_size) return -4;
        *val = pg + PAGEHDRSZ;  // contiguous across the overflow pages
        *vlen = sz;
        return 0;
    }
    *val = n.key() + n.ksize();
    *vlen = sz;
    return 0;
}

struct Cursor {
    const Db* db;
    // (pgno, next child/node index) per level, root first
    std::vector<std::pair<uint64_t, uint32_t>> stack;
    bool done;
};

}  // namespace

extern "C" {

void* lmdb_open(const char* path) {
    std::string p(path);
    struct stat st;
    if (stat(p.c_str(), &st) != 0) return nullptr;
    if (S_ISDIR(st.st_mode)) {
        p += "/data.mdb";
        if (stat(p.c_str(), &st) != 0) return nullptr;
    }
    int fd = open(p.c_str(), O_RDONLY);
    if (fd < 0) return nullptr;
    size_t sz = (size_t)st.st_size;
    void* map = mmap(nullptr, sz, PROT_READ, MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) { close(fd); return nullptr; }

    auto* db = new Db();
    db->map = (const uint8_t*)map;
    db->map_size = sz;
    db->fd = fd;

    // pick the live meta: meta0 at offset 0 (psize recorded in
    // mm_dbs[0].md_pad), meta1 at offset psize; larger mm_txnid wins.
    // meta layout after the 16B page header: magic(4) version(4) address(8)
    // mapsize(8) dbs[2] (48 each) last_pg(8) txnid(8)
    if (sz < PAGEHDRSZ + 136) { delete db; munmap(map, sz); close(fd); return nullptr; }
    const uint8_t* m0 = db->map + PAGEHDRSZ;
    if (rd32(m0) != MDB_MAGIC || !(page_flags(db->map) & P_META)) {
        delete db; munmap(map, sz); close(fd); return nullptr;
    }
    db->psize = rd32(m0 + 24);  // dbs[0].md_pad
    if (db->psize < 512 || (size_t)db->psize * 2 > sz) {
        delete db; munmap(map, sz); close(fd); return nullptr;
    }
    const uint8_t* best = m0;
    uint64_t best_txn = rd64(m0 + 24 + 96 + 8);
    const uint8_t* pg1 = db->map + db->psize;
    const uint8_t* m1 = pg1 + PAGEHDRSZ;
    if (rd32(m1) == MDB_MAGIC && (page_flags(pg1) & P_META) &&
        rd64(m1 + 24 + 96 + 8) >= best_txn) {
        best = m1;
    }

    const uint8_t* main_db = best + 24 + 48;  // mm_dbs[1]
    uint16_t md_flags = rd16(main_db + 4);
    if (md_flags & 0x04 /*MDB_DUPSORT*/) { delete db; munmap(map, sz); close(fd); return nullptr; }
    db->depth = rd16(main_db + 6);
    db->entries = rd64(main_db + 32);
    db->root = rd64(main_db + 40);
    return db;
}

void lmdb_close(void* h) {
    auto* db = (Db*)h;
    if (!db) return;
    munmap((void*)db->map, db->map_size);
    close(db->fd);
    delete db;
}

int64_t lmdb_entries(void* h) { return h ? (int64_t)((Db*)h)->entries : -1; }

int lmdb_get(void* h, const uint8_t* key, size_t klen,
             const uint8_t** val, size_t* vlen) {
    auto* db = (Db*)h;
    if (!db || db->root == ~0ull) return -1;  // empty DB
    const uint8_t* pg = db->page(db->root);
    for (int guard = 0; guard < 64 && pg; guard++) {
        uint16_t flags = page_flags(pg);
        uint16_t n = numkeys(pg);
        if (flags & P_BRANCH) {
            // descend to the last child whose key <= search key
            // (node 0 has an implicit empty key)
            uint32_t lo = 1, hi = n, child = 0;
            while (lo < hi) {
                uint32_t mid = (lo + hi) / 2;
                Node nd = node_at(pg, (uint16_t)mid);
                if (cmp_keys(nd.key(), nd.ksize(), key, klen) <= 0) lo = mid + 1;
                else hi = mid;
            }
            child = lo - 1;
            pg = db->page(node_at(pg, (uint16_t)child).pgno());
        } else if (flags & P_LEAF) {
            if (flags & P_LEAF2) return -3;  // fixed-size dup leaves: unsupported
            uint32_t lo = 0, hi = n;
            while (lo < hi) {
                uint32_t mid = (lo + hi) / 2;
                Node nd = node_at(pg, (uint16_t)mid);
                int c = cmp_keys(nd.key(), nd.ksize(), key, klen);
                if (c == 0) return node_value(*db, nd, val, vlen);
                if (c < 0) lo = mid + 1; else hi = mid;
            }
            return -1;
        } else {
            return -2;  // corrupt / unexpected page type
        }
    }
    return -2;
}

void* lmdb_cursor_open(void* h) {
    auto* db = (Db*)h;
    if (!db) return nullptr;
    auto* cur = new Cursor{db, {}, db->root == ~0ull};
    if (!cur->done) cur->stack.push_back({db->root, 0});
    return cur;
}

int lmdb_cursor_next(void* hc, const uint8_t** key, size_t* klen,
                     const uint8_t** val, size_t* vlen) {
    auto* cur = (Cursor*)hc;
    if (!cur || cur->done) return -1;
    while (!cur->stack.empty()) {
        auto& [pgno, idx] = cur->stack.back();
        const uint8_t* pg = cur->db->page(pgno);
        if (!pg) { cur->done = true; return -2; }
        uint16_t flags = page_flags(pg), n = numkeys(pg);
        if (idx >= n) { cur->stack.pop_back(); continue; }
        if (flags & P_BRANCH) {
            uint64_t child = node_at(pg, (uint16_t)idx).pgno();
            idx++;
            cur->stack.push_back({child, 0});
        } else if (flags & P_LEAF) {
            Node nd = node_at(pg, (uint16_t)idx);
            idx++;
            *key = nd.key();
            *klen = nd.ksize();
            int rc = node_value(*cur->db, nd, val, vlen);
            if (rc != 0) { cur->done = true; return rc; }
            return 0;
        } else {
            cur->done = true;
            return -2;
        }
    }
    cur->done = true;
    return -1;
}

void lmdb_cursor_close(void* hc) { delete (Cursor*)hc; }

}  // extern "C"
