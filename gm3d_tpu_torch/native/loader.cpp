// gm3d native IO: threaded point-cloud batch loader.
//
// The port's copy of gm3d_tpu/native/loader.cpp, the host-side equivalent of
// the reference's torch DataLoader worker pool (tools/builder.py:14-31 +
// datasets/ShapeNet55Dataset.py): worker threads read .npy clouds,
// random-subsample to npoints, unit-sphere normalise, and assemble batches
// into a bounded buffer so the GPU never waits on host IO. Exposed as a C API
// consumed via ctypes (native_loader.py).
//
// One change from the JAX package's copy: batches are handed out in the
// epoch's order whatever order the workers finish in (a reorder buffer keyed
// by position), so the batches are f(seed, epoch) for any worker count. Every
// data-parallel rank runs the same loader and keeps its rows of each batch;
// with the JAX copy's completion order, ranks with several workers would hold
// other batches and train some clouds twice and others not at all.
//
// Build: native_loader.py runs g++ -O3 -std=c++17 -fPIC -pthread -shared at
// first use, into gm3d_tpu_torch/build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal .npy reader: v1/v2 headers, little-endian f4/f8, C-order, 2-D (N,3).
// ---------------------------------------------------------------------------
bool read_npy_points(const std::string& path, std::vector<float>& out,
                     int64_t& rows, int64_t& cols) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t header_len = 0;
  if (ver[0] == 1) {
    uint16_t hl;
    f.read(reinterpret_cast<char*>(&hl), 2);
    header_len = hl;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  std::string header(header_len, '\0');
  f.read(header.data(), header_len);

  bool f8 = header.find("<f8") != std::string::npos;
  if (!f8 && header.find("<f4") == std::string::npos) return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  auto sp = header.find("'shape':");
  auto lp = header.find('(', sp);
  auto rp = header.find(')', lp);
  if (sp == std::string::npos || lp == std::string::npos || rp == std::string::npos)
    return false;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  rows = cols = 0;
  if (std::sscanf(shape.c_str(), "%ld, %ld", &rows, &cols) != 2 &&
      std::sscanf(shape.c_str(), "%ld,%ld", &rows, &cols) != 2)
    return false;

  const int64_t count = rows * cols;
  out.resize(count);
  if (f8) {
    std::vector<double> tmp(count);
    f.read(reinterpret_cast<char*>(tmp.data()), count * 8);
    for (int64_t i = 0; i < count; ++i) out[i] = static_cast<float>(tmp[i]);
  } else {
    f.read(reinterpret_cast<char*>(out.data()), count * 4);
  }
  return static_cast<bool>(f);
}

// unit-sphere normalise in place (datasets/ShapeNet55Dataset.py:44-50)
void pc_normalize(float* pts, int64_t n) {
  double cx = 0, cy = 0, cz = 0;
  for (int64_t i = 0; i < n; ++i) {
    cx += pts[3 * i];
    cy += pts[3 * i + 1];
    cz += pts[3 * i + 2];
  }
  cx /= n; cy /= n; cz /= n;
  double maxd = 0;
  for (int64_t i = 0; i < n; ++i) {
    pts[3 * i] -= static_cast<float>(cx);
    pts[3 * i + 1] -= static_cast<float>(cy);
    pts[3 * i + 2] -= static_cast<float>(cz);
    const double d = double(pts[3 * i]) * pts[3 * i] +
                     double(pts[3 * i + 1]) * pts[3 * i + 1] +
                     double(pts[3 * i + 2]) * pts[3 * i + 2];
    if (d > maxd) maxd = d;
  }
  const float inv = maxd > 0 ? static_cast<float>(1.0 / std::sqrt(maxd)) : 1.0f;
  for (int64_t i = 0; i < 3 * n; ++i) pts[i] *= inv;
}

// one prepared sample: points + (optional) class label + per-point seg ids.
// The label travels WITH the sample through the buffer, so the workers'
// completion order can never mis-pair them. An unreadable file leaves a
// sample with ok false in its position, which next() skips.
struct Sample {
  std::vector<float> pts;      // npoints * 3
  int32_t cls = -1;            // per-file class id (labelled datasets)
  std::vector<int32_t> seg;    // npoints (ShapeNetPart part ids), optional
  bool ok = true;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int32_t> labels;  // empty for unlabelled datasets
  int npoints;
  int batch_size;
  int num_workers;
  unsigned seed;
  bool shuffle;
  bool with_seg;

  std::vector<uint32_t> order;
  std::atomic<size_t> next_item{0};
  std::atomic<long> read_errors{0};  // unreadable/invalid files (see next())
  size_t epoch = 0;

  // ready samples keyed by their position in the epoch's order; next() hands
  // out position `emit` next. A worker waits while its position is max_queue
  // or more past `emit`: the worker holding position `emit` is always let in,
  // so the buffer stays bounded and never stalls.
  std::map<size_t, Sample> ready;
  size_t emit = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_queue;
  std::atomic<bool> stop_flag{false};
  std::vector<std::thread> workers;

  Loader(std::vector<std::string> p, std::vector<int32_t> lbl, int np, int bs,
         int nw, unsigned sd, bool sh, bool sg)
      : paths(std::move(p)), labels(std::move(lbl)), npoints(np),
        batch_size(bs), num_workers(nw), seed(sd), shuffle(sh), with_seg(sg),
        max_queue(static_cast<size_t>(bs) * 4) {
    order.resize(paths.size());
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
    reshuffle();
    start_workers();
  }

  void reshuffle() {
    // rebuild from identity so the order is purely f(seed, epoch) — shuffling
    // the previous epoch's order in place would make it history-dependent and
    // unrestorable by set_epoch (the resume contract)
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937 rng(seed + static_cast<unsigned>(epoch));
      std::shuffle(order.begin(), order.end(), rng);
    }
  }

  void worker(int wid) {
    std::vector<float> raw;
    while (!stop_flag.load()) {
      const size_t item = next_item.fetch_add(1);
      if (item >= order.size()) break;
      const uint32_t file_idx = order[item];
      int64_t rows = 0, cols = 0;
      Sample s;
      // unreadable/invalid files are counted, not silently dropped — the
      // consumer raises after the epoch so the shortfall is never invisible
      if (!read_npy_points(paths[file_idx], raw, rows, cols) || cols < 3 ||
          rows <= 0 || (with_seg && cols < 4)) {
        read_errors.fetch_add(1);
        s.ok = false;
        if (!push(item, std::move(s))) break;
        continue;
      }

      s.pts.resize(static_cast<size_t>(npoints) * 3);
      s.cls = labels.empty() ? -1 : labels[file_idx];
      if (with_seg) s.seg.resize(npoints);
      std::mt19937 rng(seed * 2654435761u + static_cast<unsigned>(epoch) * 40503u +
                       file_idx);
      if (with_seg) {
        // WITH replacement: the reference PartNormalDataset subsamples via
        // np.random.choice(..., replace=True) and the Python ShapeNetPart
        // reader matches it — the native path must too
        std::uniform_int_distribution<int64_t> dist(0, rows - 1);
        for (int64_t i = 0; i < npoints; ++i) {
          const int64_t src = dist(rng);
          s.pts[3 * i] = raw[src * cols];
          s.pts[3 * i + 1] = raw[src * cols + 1];
          s.pts[3 * i + 2] = raw[src * cols + 2];
          s.seg[i] = static_cast<int32_t>(raw[src * cols + (cols - 1)]);
        }
      } else {
        // WITHOUT replacement (ShapeNet55 contract: shuffled permutation
        // subset); partial Fisher-Yates
        std::vector<uint32_t> idx(rows);
        for (int64_t i = 0; i < rows; ++i) idx[i] = static_cast<uint32_t>(i);
        const int64_t take = std::min<int64_t>(npoints, rows);
        for (int64_t i = 0; i < take; ++i) {
          std::uniform_int_distribution<int64_t> dist(i, rows - 1);
          std::swap(idx[i], idx[dist(rng)]);
          const uint32_t src = idx[i];
          s.pts[3 * i] = raw[src * cols];
          s.pts[3 * i + 1] = raw[src * cols + 1];
          s.pts[3 * i + 2] = raw[src * cols + 2];
        }
        // pad by repetition if the cloud is smaller than npoints
        for (int64_t i = take; i < npoints; ++i) {
          const int64_t src = i % take;
          s.pts[3 * i] = s.pts[3 * src];
          s.pts[3 * i + 1] = s.pts[3 * src + 1];
          s.pts[3 * i + 2] = s.pts[3 * src + 2];
        }
      }
      pc_normalize(s.pts.data(), npoints);
      if (!push(item, std::move(s))) break;
    }
  }

  // files position `item`'s sample once it is inside the window; false when
  // the loader is stopping. Under mu, so next() cannot miss the wakeup.
  bool push(size_t item, Sample s) {
    std::unique_lock<std::mutex> lk(mu);
    cv_space.wait(lk, [&] { return item < emit + max_queue || stop_flag.load(); });
    if (stop_flag.load()) return false;
    ready.emplace(item, std::move(s));
    cv_ready.notify_one();
    return true;
  }

  void start_workers() {
    for (int i = 0; i < num_workers; ++i)
      workers.emplace_back(&Loader::worker, this, i);
  }

  void join_workers() {
    for (auto& t : workers) t.join();
    workers.clear();
  }

  // returns 1 on batch, 0 on epoch end (and restarts the next epoch);
  // out_cls / out_seg may be null for unlabelled consumption
  int next(float* out, int32_t* out_cls, int32_t* out_seg) {
    for (int b = 0; b < batch_size;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return emit >= order.size() || ready.count(emit) > 0; });
      if (emit >= order.size()) {
        // epoch exhausted mid-batch: drop remainder (drop_last), restart
        lk.unlock();
        advance_epoch();
        return 0;
      }
      auto it = ready.find(emit);
      Sample sample = std::move(it->second);
      ready.erase(it);
      ++emit;
      lk.unlock();
      // every waiting worker: the one whose position just entered the window
      // may not be the one a single notify would wake
      cv_space.notify_all();
      if (!sample.ok) continue;  // counted in read_errors
      std::memcpy(out + static_cast<size_t>(b) * npoints * 3, sample.pts.data(),
                  sizeof(float) * npoints * 3);
      if (out_cls) out_cls[b] = sample.cls;
      if (out_seg && with_seg)
        std::memcpy(out_seg + static_cast<size_t>(b) * npoints,
                    sample.seg.data(), sizeof(int32_t) * npoints);
      ++b;
    }
    return 1;
  }

  void advance_epoch() { set_epoch(epoch + 1); }

  // jump to an arbitrary epoch's shuffle order (resume support: the Python
  // DataLoader reshuffles as f(seed, epoch) and restores on load_state; the
  // native path must honor the same contract or a resumed run silently
  // replays epoch-0 order). Safe mid-epoch: in-flight workers are stopped
  // (they may be blocked on cv_space), queued samples discarded, and the
  // epoch rebuilt from item 0.
  void set_epoch(size_t e) {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop_flag.store(true);
    }
    cv_space.notify_all();
    join_workers();
    stop_flag.store(false);
    {
      std::lock_guard<std::mutex> lk(mu);
      ready.clear();
      emit = 0;
    }
    epoch = e;
    reshuffle();
    next_item.store(0);
    start_workers();
  }

  ~Loader() {
    {
      // under mu for the same lost-wakeup reason as the worker-exit path
      std::lock_guard<std::mutex> lk(mu);
      stop_flag.store(true);
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    join_workers();
  }
};

}  // namespace

extern "C" {

void* gm3d_loader_create(const char** paths, int n_files, int npoints,
                         int batch_size, int num_workers, unsigned seed,
                         int shuffle) {
  std::vector<std::string> p(paths, paths + n_files);
  return new Loader(std::move(p), {}, npoints, batch_size, num_workers, seed,
                    shuffle != 0, false);
}

// labelled variant: per-file int class labels; with_seg additionally returns
// the last npy column as per-point int32 part ids (ShapeNetPart caches are
// (N, 7) x y z nx ny nz part)
void* gm3d_labelled_loader_create(const char** paths, const int32_t* labels,
                                  int n_files, int npoints, int batch_size,
                                  int num_workers, unsigned seed, int shuffle,
                                  int with_seg) {
  std::vector<std::string> p(paths, paths + n_files);
  std::vector<int32_t> lbl(labels, labels + n_files);
  return new Loader(std::move(p), std::move(lbl), npoints, batch_size,
                    num_workers, seed, shuffle != 0, with_seg != 0);
}

int gm3d_loader_next(void* handle, float* out) {
  return static_cast<Loader*>(handle)->next(out, nullptr, nullptr);
}

int gm3d_loader_next_labelled(void* handle, float* out, int32_t* out_cls,
                              int32_t* out_seg) {
  return static_cast<Loader*>(handle)->next(out, out_cls, out_seg);
}

int gm3d_loader_num_batches(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  return static_cast<int>(l->paths.size() / l->batch_size);
}

// cumulative count of unreadable/invalid files skipped by workers; the
// Python wrapper raises when this grows so data loss is never silent
long gm3d_loader_error_count(void* handle) {
  return static_cast<Loader*>(handle)->read_errors.load();
}

// resume support: jump to epoch e's deterministic shuffle order (f(seed, e),
// the Python DataLoader contract) / report the current epoch. Call from the
// consumer thread only (same thread as gm3d_loader_next).
void gm3d_loader_set_epoch(void* handle, int epoch) {
  static_cast<Loader*>(handle)->set_epoch(static_cast<size_t>(epoch));
}

int gm3d_loader_epoch(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->epoch);
}

void gm3d_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
