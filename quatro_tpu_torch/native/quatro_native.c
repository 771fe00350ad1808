/* Native host-side data path of the PyTorch port (quatro_tpu_torch).
 *
 * A copy of quatro_tpu/native/quatro_native.c, which the port may not
 * import or build beside. The reference's IO + cloud plumbing is C++ (KITTI
 * fread loop, examples/run_global_registration.cpp:377-402; PCL cloud
 * copies throughout). Its host-side analog is this small C library:
 * zero-copy scan loading and multithreaded padded-batch packing, so feeding
 * the card never bottlenecks on Python loops.
 *
 * Exposed via ctypes (see __init__.py) — no pybind11 dependency.
 */

#define _GNU_SOURCE
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

/* ---------------------------------------------------------------- KITTI IO
 * .bin files are float32 (x, y, z, intensity) quads. Returns the number of
 * points, or -1 on error. `out` must hold at least max_points*4 floats;
 * when out is NULL only the count is returned. */
long quatro_load_kitti_bin(const char *path, float *out, long max_points) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    long n_points = (long)(st.st_size / (4 * sizeof(float)));
    if (out == NULL) { close(fd); return n_points; }
    if (n_points > max_points) n_points = max_points;
    if (n_points == 0) {  /* legitimate empty scan; mmap(0) is EINVAL */
        close(fd);
        return 0;
    }
    size_t bytes = (size_t)n_points * 4 * sizeof(float);

    void *map = mmap(NULL, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) { close(fd); return -1; }
    memcpy(out, map, bytes);
    munmap(map, st.st_size);
    close(fd);
    return n_points;
}

/* ------------------------------------------------------- padded batch pack
 * Packs B variable-length clouds into (B, cap, 3) f32 + (B, cap) u8 mask,
 * striding past the intensity channel, parallel over clouds. */
typedef struct {
    const float *const *clouds; /* each (n_i, stride) floats */
    const long *sizes;
    long stride;        /* floats per input point (4 for kitti, 3 for xyz) */
    long cap;
    float *out_points;  /* (B, cap, 3) */
    uint8_t *out_mask;  /* (B, cap) */
    long begin, end;
} pack_job_t;

/* Strided xyz copy into a padded (cap, 3) slot + mask; shared by the batch
 * packer and the streaming loader. n may exceed cap (truncates). */
static long strip_pad(const float *src, long n, long stride, long cap,
                      float *dst, uint8_t *msk) {
    if (n > cap) n = cap;
    for (long i = 0; i < n; ++i) {
        dst[i * 3 + 0] = src[i * stride + 0];
        dst[i * 3 + 1] = src[i * stride + 1];
        dst[i * 3 + 2] = src[i * stride + 2];
        msk[i] = 1;
    }
    memset(dst + n * 3, 0, (size_t)(cap - n) * 3 * sizeof(float));
    memset(msk + n, 0, (size_t)(cap - n));
    return n;
}

static void *pack_worker(void *arg) {
    pack_job_t *job = (pack_job_t *)arg;
    for (long b = job->begin; b < job->end; ++b)
        strip_pad(job->clouds[b], job->sizes[b], job->stride, job->cap,
                  job->out_points + b * job->cap * 3,
                  job->out_mask + b * job->cap);
    return NULL;
}

/* ------------------------------------------------- async prefetching loader
 * Streaming scan loader for sequence/odometry runs: a pool of worker threads
 * reads KITTI .bin files ahead of the consumer into a bounded ring of padded
 * (cap, 3) + mask slots, delivered strictly in file order. This is the
 * runtime analog of the reference's per-frame fread loop
 * (examples/run_global_registration.cpp:377-402) redesigned so host IO
 * overlaps device compute instead of serializing with it. */

enum { SLOT_EMPTY = 0, SLOT_CLAIMED = 1, SLOT_READY = 2, SLOT_DRAINING = 3 };

typedef struct {
    float *points;   /* (cap, 3) */
    uint8_t *mask;   /* (cap,) */
    long n_points;   /* valid points, or -1 on load error */
    long seq;        /* which file index occupies this slot */
    int state;       /* SLOT_EMPTY / SLOT_CLAIMED / SLOT_READY */
} loader_slot_t;

typedef struct quatro_loader {
    char **paths;
    long n_files;
    long cap;
    int depth;
    int n_workers;
    loader_slot_t *slots;
    pthread_t *workers;
    pthread_mutex_t mu;
    pthread_cond_t cv_produced;  /* a slot became ready */
    pthread_cond_t cv_consumed;  /* a slot became free */
    long next_to_load;           /* next file index a worker should claim */
    long next_to_emit;           /* next file index the consumer wants */
    int in_next;                 /* consumers currently inside loader_next */
    int shutdown;
} quatro_loader_t;

static void load_into_slot(quatro_loader_t *ld, loader_slot_t *s,
                           const char *path) {
    /* mmap the (n, 4) quads, then strip intensity into the padded slot */
    int fd = open(path, O_RDONLY);
    if (fd < 0) { s->n_points = -1; return; }
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); s->n_points = -1; return; }
    long n = (long)(st.st_size / (4 * sizeof(float)));
    if (n == 0) {  /* legitimate empty scan; mmap(0) would be EINVAL */
        close(fd);
        s->n_points = strip_pad(NULL, 0, 4, ld->cap, s->points, s->mask);
        return;
    }
    const float *map = (const float *)mmap(NULL, st.st_size, PROT_READ,
                                           MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) { close(fd); s->n_points = -1; return; }
    s->n_points = strip_pad(map, n, 4, ld->cap, s->points, s->mask);
    munmap((void *)map, st.st_size);
    close(fd);
}

static void *loader_worker(void *arg) {
    quatro_loader_t *ld = (quatro_loader_t *)arg;
    for (;;) {
        pthread_mutex_lock(&ld->mu);
        long idx;
        for (;;) {
            if (ld->shutdown || ld->next_to_load >= ld->n_files) {
                pthread_mutex_unlock(&ld->mu);
                return NULL;
            }
            idx = ld->next_to_load;
            /* claim idx only once its ring slot has been drained */
            loader_slot_t *s = &ld->slots[idx % ld->depth];
            if (s->state == SLOT_EMPTY) {
                ld->next_to_load++;
                s->state = SLOT_CLAIMED;
                s->seq = idx;
                break;
            }
            pthread_cond_wait(&ld->cv_consumed, &ld->mu);
        }
        pthread_mutex_unlock(&ld->mu);

        loader_slot_t *s = &ld->slots[idx % ld->depth];
        load_into_slot(ld, s, ld->paths[idx]);

        pthread_mutex_lock(&ld->mu);
        s->state = SLOT_READY;
        pthread_cond_broadcast(&ld->cv_produced);
        pthread_mutex_unlock(&ld->mu);
    }
}

void quatro_loader_destroy(quatro_loader_t *ld);

quatro_loader_t *quatro_loader_create(const char *const *paths, long n_files,
                                      long capacity, int n_workers,
                                      int queue_depth) {
    if (n_files <= 0 || capacity <= 0) return NULL;
    if (n_workers < 1) n_workers = 1;
    if (n_workers > 32) n_workers = 32;
    if (queue_depth < 2) queue_depth = 2;
    if (queue_depth > n_files) queue_depth = (int)n_files;

    quatro_loader_t *ld = calloc(1, sizeof(*ld));
    if (!ld) return NULL;
    ld->n_files = n_files;
    ld->cap = capacity;
    ld->depth = queue_depth;
    ld->n_workers = n_workers;
    ld->paths = calloc((size_t)n_files, sizeof(char *));
    ld->slots = calloc((size_t)queue_depth, sizeof(loader_slot_t));
    ld->workers = calloc((size_t)n_workers, sizeof(pthread_t));
    if (!ld->paths || !ld->slots || !ld->workers) goto fail;
    for (long i = 0; i < n_files; ++i) {
        ld->paths[i] = strdup(paths[i]);
        if (!ld->paths[i]) goto fail;
    }
    for (int i = 0; i < queue_depth; ++i) {
        ld->slots[i].points = malloc((size_t)capacity * 3 * sizeof(float));
        ld->slots[i].mask = malloc((size_t)capacity);
        ld->slots[i].seq = -1;
        if (!ld->slots[i].points || !ld->slots[i].mask) goto fail;
    }
    pthread_mutex_init(&ld->mu, NULL);
    pthread_cond_init(&ld->cv_produced, NULL);
    pthread_cond_init(&ld->cv_consumed, NULL);
    for (int i = 0; i < n_workers; ++i) {
        if (pthread_create(&ld->workers[i], NULL, loader_worker, ld) != 0) {
            ld->n_workers = i;  /* join only the started ones */
            quatro_loader_destroy(ld);
            return NULL;
        }
    }
    return ld;

fail:
    if (ld->slots)
        for (int i = 0; i < queue_depth; ++i) {
            free(ld->slots[i].points);
            free(ld->slots[i].mask);
        }
    if (ld->paths)
        for (long i = 0; i < n_files; ++i) free(ld->paths[i]);
    free(ld->paths);
    free(ld->slots);
    free(ld->workers);
    free(ld);
    return NULL;
}

/* Blocks until scan `next_to_emit` is ready; copies it into out_points
 * (cap*3 floats) and out_mask (cap bytes). Returns the number of valid
 * points, -1 on load error for that file, or -2 when the sequence is
 * exhausted. */
long quatro_loader_next(quatro_loader_t *ld, float *out_points,
                        uint8_t *out_mask) {
    pthread_mutex_lock(&ld->mu);
    ld->in_next++;
    long idx;
    loader_slot_t *s;
    /* Re-read next_to_emit after every wake: a concurrent consumer may
     * have claimed the index we were waiting for (multi-consumer safe —
     * a stale cached idx would wait forever for a seq the ring has moved
     * past). */
    for (;;) {
        if (ld->next_to_emit >= ld->n_files || ld->shutdown) {
            ld->in_next--;
            pthread_cond_broadcast(&ld->cv_consumed);
            pthread_mutex_unlock(&ld->mu);
            return -2;
        }
        idx = ld->next_to_emit;
        s = &ld->slots[idx % ld->depth];
        if (s->state == SLOT_READY && s->seq == idx) break;
        pthread_cond_wait(&ld->cv_produced, &ld->mu);
    }
    long n = s->n_points;
    ld->next_to_emit++;
    s->state = SLOT_DRAINING;  /* copy outside the lock; workers skip it */
    /* other consumers may already have their next slot READY: wake them to
     * re-check with the advanced next_to_emit */
    pthread_cond_broadcast(&ld->cv_produced);
    pthread_mutex_unlock(&ld->mu);

    memcpy(out_points, s->points, (size_t)ld->cap * 3 * sizeof(float));
    memcpy(out_mask, s->mask, (size_t)ld->cap);

    pthread_mutex_lock(&ld->mu);
    s->state = SLOT_EMPTY;  /* slot reusable */
    ld->in_next--;
    pthread_cond_broadcast(&ld->cv_consumed);
    pthread_mutex_unlock(&ld->mu);
    return n;
}

/* Signal shutdown WITHOUT freeing: wakes every blocked quatro_loader_next
 * (they return -2) and stops the workers, but keeps the loader allocated so
 * late-arriving next() calls see the shutdown flag instead of freed memory.
 * The owner must still call quatro_loader_destroy once no consumer can
 * enter next() anymore (see ScanLoader.close in __init__.py). */
void quatro_loader_stop(quatro_loader_t *ld) {
    if (!ld) return;
    pthread_mutex_lock(&ld->mu);
    ld->shutdown = 1;
    pthread_cond_broadcast(&ld->cv_consumed);
    pthread_cond_broadcast(&ld->cv_produced);
    pthread_mutex_unlock(&ld->mu);
}

/* Safe to call while another thread is blocked in quatro_loader_next: that
 * call is woken, returns -2, and destroy waits for it to leave before
 * freeing anything. NOT safe against a consumer that has not yet ENTERED
 * loader_next — callers with concurrent consumers must quiesce them first
 * (stop + wait), as the Python wrapper does. */
void quatro_loader_destroy(quatro_loader_t *ld) {
    if (!ld) return;
    pthread_mutex_lock(&ld->mu);
    ld->shutdown = 1;
    pthread_cond_broadcast(&ld->cv_consumed);
    pthread_cond_broadcast(&ld->cv_produced);
    while (ld->in_next > 0)
        pthread_cond_wait(&ld->cv_consumed, &ld->mu);
    pthread_mutex_unlock(&ld->mu);
    for (int i = 0; i < ld->n_workers; ++i)
        pthread_join(ld->workers[i], NULL);
    for (int i = 0; i < ld->depth; ++i) {
        free(ld->slots[i].points);
        free(ld->slots[i].mask);
    }
    for (long i = 0; i < ld->n_files; ++i) free(ld->paths[i]);
    free(ld->paths);
    free(ld->slots);
    free(ld->workers);
    pthread_mutex_destroy(&ld->mu);
    pthread_cond_destroy(&ld->cv_produced);
    pthread_cond_destroy(&ld->cv_consumed);
    free(ld);
}

int quatro_pack_batch(const float *const *clouds, const long *sizes, long b,
                      long stride, long cap, float *out_points,
                      uint8_t *out_mask, int n_threads) {
    if (b <= 0) return 0;  /* empty batch: nothing to pack (b=0 would make
                              the chunk math divide by zero) */
    if (n_threads < 1) n_threads = 1;
    if (n_threads > b) n_threads = (int)b;
    pthread_t threads[64];
    pack_job_t jobs[64];
    if (n_threads > 64) n_threads = 64;
    long chunk = (b + n_threads - 1) / n_threads;
    int started = 0;
    for (int t = 0; t < n_threads; ++t) {
        long begin = t * chunk;
        long end = begin + chunk > b ? b : begin + chunk;
        if (begin >= end) break;
        jobs[t] = (pack_job_t){clouds, sizes, stride, cap,
                               out_points, out_mask, begin, end};
        if (pthread_create(&threads[t], NULL, pack_worker, &jobs[t]) != 0) {
            /* Thread exhaustion: run this chunk (and the rest) inline
             * rather than returning with spawned workers still touching
             * this stack frame — the jobs/threads arrays must outlive
             * every worker. */
            pack_worker(&jobs[t]);
            for (int r = t + 1; r < n_threads; ++r) {
                long rb = r * chunk;
                long re = rb + chunk > b ? b : rb + chunk;
                if (rb >= re) break;
                pack_job_t j = {clouds, sizes, stride, cap,
                                out_points, out_mask, rb, re};
                pack_worker(&j);
            }
            break;
        }
        started++;
    }
    for (int t = 0; t < started; ++t) pthread_join(threads[t], NULL);
    return 0;
}
