// Native brick IO: batched mmap read + zlib inflate on a thread pool.
//
// The equivalent of the reference's per-brick UVF fetch path
// (datasources/uvf/UVFDataSource.cpp:249-301: TOC lookup -> mmap read ->
// zlib decompress) combined with the 4-thread upload executor sharding of
// GLRenderUploadFilter.cpp:79-107 — the host half of the out-of-core
// paging pipeline, feeding the device atlas.
//
// Build: make -C native   (g++ -O2 -fPIC -shared, links zlib/pthread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct MappedFile {
    int fd = -1;
    const uint8_t* data = nullptr;
    uint64_t size = 0;

    bool open_file(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) return false;
        size = static_cast<uint64_t>(st.st_size);
        void* p = ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) return false;
        data = static_cast<const uint8_t*>(p);
        ::madvise(p, size, MADV_WILLNEED);
        return true;
    }

    ~MappedFile() {
        if (data) ::munmap(const_cast<uint8_t*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

}  // namespace

extern "C" {

// Read `n` bricks from `path`: brick i spans [blob_base + offsets[i],
// +nbytes[i]) in the file and inflates (if `compressed`) to `raw_nbytes`
// bytes written at out + i*raw_nbytes.  Returns 0 on success, else the
// 1-based index of the first failing brick, or -1 for file errors.
int ltpu_read_bricks(const char* path, uint64_t blob_base,
                     const uint64_t* offsets, const uint64_t* nbytes,
                     uint64_t raw_nbytes, int compressed, int n,
                     uint8_t* out, int n_threads) {
    MappedFile f;
    if (!f.open_file(path)) return -1;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;

    std::atomic<int> next(0);
    std::atomic<int> failed(0);

    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n || failed.load() != 0) return;
            const uint64_t off = blob_base + offsets[i];
            if (off + nbytes[i] > f.size) {
                failed.store(i + 1);
                return;
            }
            const uint8_t* src = f.data + off;
            uint8_t* dst = out + static_cast<uint64_t>(i) * raw_nbytes;
            if (compressed) {
                uLongf dst_len = raw_nbytes;
                const int rc = uncompress(dst, &dst_len, src, nbytes[i]);
                if (rc != Z_OK || dst_len != raw_nbytes) {
                    failed.store(i + 1);
                    return;
                }
            } else {
                if (nbytes[i] != raw_nbytes) {
                    failed.store(i + 1);
                    return;
                }
                std::memcpy(dst, src, raw_nbytes);
            }
        }
    };

    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return failed.load();
}

// Deflate `n` equally-sized bricks (raw_nbytes each, packed in `in`) on a
// thread pool; blob i is written at out + i*bound and its final size in
// out_sizes[i].  `bound` must be >= compressBound(raw_nbytes).  The store
// builder uses this to compress LOD pyramids in parallel.
int ltpu_compress_bricks(const uint8_t* in, uint64_t raw_nbytes, int n,
                         int level, uint8_t* out, uint64_t bound,
                         uint64_t* out_sizes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    std::atomic<int> next(0);
    std::atomic<int> failed(0);

    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n || failed.load() != 0) return;
            uLongf dst_len = bound;
            const int rc =
                compress2(out + static_cast<uint64_t>(i) * bound, &dst_len,
                          in + static_cast<uint64_t>(i) * raw_nbytes,
                          raw_nbytes, level);
            if (rc != Z_OK) {
                failed.store(i + 1);
                return;
            }
            out_sizes[i] = dst_len;
        }
    };

    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return failed.load();
}

uint64_t ltpu_compress_bound(uint64_t raw_nbytes) {
    return compressBound(raw_nbytes);
}

}  // extern "C"
