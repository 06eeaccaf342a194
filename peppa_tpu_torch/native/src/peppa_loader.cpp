// peppa_loader.cpp: the native batch loader of the port's data pipeline.
//
// Mirrors peppa_tpu/native/src/peppa_loader.cpp, with the same C ABI:
//   * a packed cache file (written by peppa_tpu_torch/data/cache.py): header
//     + fixed-size index + raw payloads (uint8 video, f32 or int16 audio),
//     memory-mapped, so an item read is a page-cache hit with no
//     deserialisation; every entry is bounds-checked when the pack is opened;
//   * a pthread worker pool that assembles whole padded batches (zero-padded
//     to the caller's bucket shapes) and hands them over in order through a
//     bounded ring; `ppk_loader_next` copies the next one into the caller's
//     buffers (on the card, pinned host tensors that the copy to the device
//     reads directly).
//
// Video stays uint8 and int16 audio stays int16 up to the device, where the
// towers convert them.  Plain C ABI for ctypes; pthread and libc only.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x434b5050;  // "PPKC" little-endian
// v1: audio payload f32.  v2: audio payload int16 (value = round(f * 32768),
// the exact inverse of the 16-bit-wav -> float scaling the decode path uses,
// so packing real media round-trips bit-exactly while halving audio bytes on
// disk AND host->device).  The loader delivers audio in the pack's dtype;
// the audio encoder converts on device (models/wav2vec2.py), like uint8
// video.
constexpr uint32_t kVersionF32 = 1;
constexpr uint32_t kVersionI16 = 2;

#pragma pack(push, 1)
struct PackHeader {
  uint32_t magic;
  uint32_t version;
  uint64_t n_items;
};

struct ItemEntry {
  uint64_t video_off;  // byte offset of uint8 video payload
  uint32_t t, h, w, c; // video shape
  uint64_t audio_off;  // byte offset of f32 audio payload
  uint64_t s;          // audio samples
  float video_duration;
  float audio_duration;
};
#pragma pack(pop)

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  const ItemEntry* index = nullptr;
  uint64_t n_items = 0;
  uint32_t version = kVersionF32;
  size_t audio_bps() const {  // bytes per audio sample in pack AND output
    return version == kVersionI16 ? sizeof(int16_t) : sizeof(float);
  }
};

struct BatchSpec {
  std::vector<int64_t> items;
  int64_t pad_t, pad_h, pad_w, pad_c, pad_s;
};

struct BatchBuf {
  std::vector<uint8_t> video;
  std::vector<uint8_t> audio;  // raw bytes: f32 (v1) or int16 (v2) samples
  std::vector<float> vdur, adur;
  std::vector<int32_t> vframes;
  std::vector<int64_t> asamples;
  bool ready = false;
};

struct Loader {
  const Pack* pack = nullptr;
  std::vector<BatchSpec> batches;
  uint32_t depth = 4;
  std::vector<std::thread> workers;
  std::atomic<uint64_t> next_job{0};
  uint64_t next_out = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<BatchBuf> ring;
  std::atomic<bool> stop{false};

  ~Loader() {
    // stop must flip under the mutex: a thread that evaluated its wait
    // predicate (false) but has not yet blocked would otherwise miss the
    // notify and sleep forever, deadlocking the joins below.
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

void assemble(const Pack& pack, const BatchSpec& spec, BatchBuf* out) {
  const size_t b = spec.items.size();
  const size_t frame = size_t(spec.pad_h) * spec.pad_w * spec.pad_c;
  const size_t vitem = size_t(spec.pad_t) * frame;
  const size_t bps = pack.audio_bps();
  out->video.assign(b * vitem, 0);
  out->audio.assign(b * size_t(spec.pad_s) * bps, 0);
  out->vdur.resize(b);
  out->adur.resize(b);
  out->vframes.resize(b);
  out->asamples.resize(b);
  for (size_t i = 0; i < b; ++i) {
    const ItemEntry& e = pack.index[spec.items[i]];
    const int64_t t = std::min<int64_t>(e.t, spec.pad_t);
    // frames are copied row-contiguously when H/W/C match the pad shape
    // (the common case: one resolution per cache)
    if (e.h == spec.pad_h && e.w == spec.pad_w && e.c == spec.pad_c) {
      std::memcpy(out->video.data() + i * vitem, pack.base + e.video_off,
                  size_t(t) * frame);
    } else {
      const size_t src_row = size_t(e.w) * e.c;
      const size_t dst_row = size_t(spec.pad_w) * spec.pad_c;
      for (int64_t f = 0; f < t; ++f)
        for (uint32_t y = 0; y < e.h && y < spec.pad_h; ++y)
          std::memcpy(out->video.data() + i * vitem + f * frame + y * dst_row,
                      pack.base + e.video_off + (size_t(f) * e.h + y) * src_row,
                      std::min(src_row, dst_row));
    }
    const int64_t s = std::min<int64_t>(e.s, spec.pad_s);
    std::memcpy(out->audio.data() + i * spec.pad_s * bps,
                pack.base + e.audio_off, size_t(s) * bps);
    out->vdur[i] = e.video_duration;
    out->adur[i] = e.audio_duration;
    out->vframes[i] = int32_t(t);
    out->asamples[i] = s;
  }
  out->ready = true;
}

void worker_main(Loader* ld) {
  for (;;) {
    if (ld->stop.load()) return;
    const uint64_t job = ld->next_job.fetch_add(1);
    if (job >= ld->batches.size()) return;
    const uint32_t slot = job % ld->depth;
    BatchBuf local;
    assemble(*ld->pack, ld->batches[job], &local);
    std::unique_lock<std::mutex> lk(ld->mu);
    // wait until our slot is free (consumer drained batch job - depth)
    ld->cv_space.wait(lk, [&] {
      return ld->stop.load() ||
             (job < ld->next_out + ld->depth && !ld->ring[slot].ready);
    });
    if (ld->stop.load()) return;
    ld->ring[slot] = std::move(local);
    ld->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* ppk_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(PackHeader)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* hdr = reinterpret_cast<const PackHeader*>(base);
  if (hdr->magic != kMagic ||
      (hdr->version != kVersionF32 && hdr->version != kVersionI16)) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  // Bounds-validate the whole pack up front so a truncated or stale file
  // (e.g. a write interrupted before os.replace) fails cleanly here instead
  // of SIGSEGVing inside a worker-thread memcpy later.
  const size_t size = size_t(st.st_size);
  const uint64_t n = hdr->n_items;
  if (n > (size - sizeof(PackHeader)) / sizeof(ItemEntry)) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  const auto* index = reinterpret_cast<const ItemEntry*>(
      reinterpret_cast<const uint8_t*>(base) + sizeof(PackHeader));
  for (uint64_t i = 0; i < n; ++i) {
    const ItemEntry& e = index[i];
    // Per-factor limits BEFORE multiplying: corrupt dims like t=h=2^32 would
    // wrap uint64 vbytes to a small value and sail past the range check,
    // re-opening the exact worker-thread OOB memcpy this validation exists
    // to prevent.  No real clip exceeds any of these bounds (nor does any
    // product of them overflow 64 bits: 2^20 * 2^16 * 2^16 * 2^8 = 2^60).
    if (e.t > (1u << 20) || e.h > (1u << 16) || e.w > (1u << 16) ||
        e.c > (1u << 8) || e.s > (uint64_t(1) << 40)) {
      munmap(base, st.st_size);
      close(fd);
      return nullptr;
    }
    const uint64_t vbytes = uint64_t(e.t) * e.h * e.w * e.c;
    const uint64_t abytes =
        e.s * (hdr->version == kVersionI16 ? sizeof(int16_t) : sizeof(float));
    if (e.video_off > size || vbytes > size - e.video_off ||
        e.audio_off > size || abytes > size - e.audio_off) {
      munmap(base, st.st_size);
      close(fd);
      return nullptr;
    }
  }
  auto* p = new Pack;
  p->fd = fd;
  p->base = reinterpret_cast<const uint8_t*>(base);
  p->size = size;
  p->n_items = n;
  p->index = index;
  p->version = hdr->version;
  return p;
}

uint32_t ppk_version(void* handle) {
  return static_cast<Pack*>(handle)->version;
}

void ppk_close(void* handle) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t*>(p->base), p->size);
  close(p->fd);
  delete p;
}

uint64_t ppk_len(void* handle) { return static_cast<Pack*>(handle)->n_items; }

// meta[0..3] = t,h,w,c; meta[4] = s; durs[0] = video, durs[1] = audio
int ppk_item_meta(void* handle, uint64_t idx, uint64_t* meta, float* durs) {
  auto* p = static_cast<Pack*>(handle);
  if (idx >= p->n_items) return -1;
  const ItemEntry& e = p->index[idx];
  meta[0] = e.t;
  meta[1] = e.h;
  meta[2] = e.w;
  meta[3] = e.c;
  meta[4] = e.s;
  durs[0] = e.video_duration;
  durs[1] = e.audio_duration;
  return 0;
}

// Copy one item's payloads into caller buffers: video uint8; audio in the
// pack's sample dtype (f32 for v1, int16 for v2 — query ppk_version).
int ppk_item_data(void* handle, uint64_t idx, uint8_t* video, void* audio) {
  auto* p = static_cast<Pack*>(handle);
  if (idx >= p->n_items) return -1;
  const ItemEntry& e = p->index[idx];
  std::memcpy(video, p->base + e.video_off,
              size_t(e.t) * e.h * e.w * e.c);
  std::memcpy(audio, p->base + e.audio_off, size_t(e.s) * p->audio_bps());
  return 0;
}

// batch_items: concatenated item indices; batch_sizes[i] items per batch i;
// pads: per-batch [pad_t, pad_h, pad_w, pad_c, pad_s].
void* ppk_loader_new(void* pack_handle, const int64_t* batch_items,
                     const int64_t* batch_sizes, const int64_t* pads,
                     uint64_t n_batches, uint32_t n_threads, uint32_t depth) {
  auto* ld = new Loader;
  ld->pack = static_cast<Pack*>(pack_handle);
  ld->depth = depth < 2 ? 2 : depth;
  ld->batches.resize(n_batches);
  const int64_t* it = batch_items;
  for (uint64_t i = 0; i < n_batches; ++i) {
    BatchSpec& s = ld->batches[i];
    s.items.assign(it, it + batch_sizes[i]);
    it += batch_sizes[i];
    s.pad_t = pads[i * 5 + 0];
    s.pad_h = pads[i * 5 + 1];
    s.pad_w = pads[i * 5 + 2];
    s.pad_c = pads[i * 5 + 3];
    s.pad_s = pads[i * 5 + 4];
  }
  ld->ring.resize(ld->depth);
  const uint32_t threads = n_threads ? n_threads : 4;
  for (uint32_t i = 0; i < threads; ++i)
    ld->workers.emplace_back(worker_main, ld);
  return ld;
}

// Blocks until the next in-order batch is assembled, then copies it out.
// Returns the batch index, or -1 when exhausted.
int64_t ppk_loader_next(void* handle, uint8_t* video, void* audio,
                        float* vdur, float* adur, int32_t* vframes,
                        int64_t* asamples) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->next_out >= ld->batches.size()) return -1;
  const uint64_t job = ld->next_out;
  const uint32_t slot = job % ld->depth;
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_ready.wait(lk, [&] { return ld->stop.load() || ld->ring[slot].ready; });
  if (ld->stop.load()) return -1;
  BatchBuf buf = std::move(ld->ring[slot]);
  ld->ring[slot] = BatchBuf{};
  ld->next_out = job + 1;
  ld->cv_space.notify_all();
  lk.unlock();
  std::memcpy(video, buf.video.data(), buf.video.size());
  std::memcpy(audio, buf.audio.data(), buf.audio.size());  // raw bytes
  std::memcpy(vdur, buf.vdur.data(), buf.vdur.size() * sizeof(float));
  std::memcpy(adur, buf.adur.data(), buf.adur.size() * sizeof(float));
  std::memcpy(vframes, buf.vframes.data(), buf.vframes.size() * sizeof(int32_t));
  std::memcpy(asamples, buf.asamples.data(),
              buf.asamples.size() * sizeof(int64_t));
  return int64_t(job);
}

void ppk_loader_free(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
