/* Record-store IO of unicore_tpu_torch's data tier, with a plain C
 * interface (no Python C API): loaded with ctypes, whose foreign calls
 * run with the GIL released, so thread data workers overlap their disk
 * reads.  The port's copy of csrc/record_reader.c.
 *
 *   rr_read_spans(path, starts, lens, n, out) -> 0 or an error code
 *       One pread(2) loop per span into the caller's buffer `out`, the
 *       spans laid end to end in the order given.
 *
 *   rr_readahead(path, starts, lens, n) -> bytes touched, or -errno
 *       Page-cache warmup: posix_fadvise(WILLNEED) per span, then a
 *       bounded sequential pread sweep of it through a 1 MiB scratch
 *       buffer.  No caller memory is held: the kernel has the spans hot
 *       when the reader faults them in.
 *
 * (The rr_ prefix keeps clear of libc's own readahead(2).)  Error
 * codes of rr_read_spans: RR_BAD_SPAN for a negative start or length,
 * RR_SHORT_READ when a span ends past the end of the file, otherwise
 * the errno of the failed open or pread.
 */

#define _POSIX_C_SOURCE 200809L
#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdlib.h>
#include <unistd.h>

#define RR_BAD_SPAN (-1)
#define RR_SHORT_READ (-2)

static int spans_ok(const int64_t *starts, const int64_t *lens, int64_t n) {
    for (int64_t i = 0; i < n; i++)
        if (starts[i] < 0 || lens[i] < 0) return 0;
    return 1;
}

/* 0 when all len bytes at off were read; RR_SHORT_READ at end of file;
 * else the errno of the failed pread. */
static int pread_full(int fd, char *buf, int64_t len, int64_t off) {
    int64_t done = 0;
    while (done < len) {
        ssize_t r = pread(fd, buf + done, (size_t)(len - done), off + done);
        if (r < 0) {
            if (errno == EINTR) continue;
            return errno ? errno : EIO;
        }
        if (r == 0) return RR_SHORT_READ;
        done += r;
    }
    return 0;
}

int rr_read_spans(const char *path, const int64_t *starts,
                  const int64_t *lens, int64_t n, char *out) {
    if (!spans_ok(starts, lens, n)) return RR_BAD_SPAN;
    int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return errno ? errno : EIO;
    int rc = 0;
    for (int64_t i = 0; i < n && rc == 0; i++) {
        rc = pread_full(fd, out, lens[i], starts[i]);
        out += lens[i];
    }
    close(fd);
    return rc;
}

int64_t rr_readahead(const char *path, const int64_t *starts,
                     const int64_t *lens, int64_t n) {
    if (!spans_ok(starts, lens, n)) return -EINVAL;
    int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return -(int64_t)(errno ? errno : EIO);
    enum { SCRATCH = 1 << 20 };
    char *scratch = (char *)malloc(SCRATCH);
    if (scratch == NULL) {
        close(fd);
        return -ENOMEM;
    }
    int64_t touched = 0;
    for (int64_t i = 0; i < n; i++) {
#ifdef POSIX_FADV_WILLNEED
        posix_fadvise(fd, (off_t)starts[i], (off_t)lens[i],
                      POSIX_FADV_WILLNEED);
#endif
        int64_t off = starts[i], left = lens[i];
        while (left > 0) {
            int64_t chunk = left < SCRATCH ? left : SCRATCH;
            ssize_t r = pread(fd, scratch, (size_t)chunk, off);
            if (r <= 0) break; /* end of file or an error: a warmup only */
            off += r;
            left -= r;
            touched += r;
        }
    }
    free(scratch);
    close(fd);
    return touched;
}
