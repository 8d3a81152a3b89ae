// Host dependency engine + pooled host storage of the PyTorch port.
//
// A copy of mxnet_tpu/native/engine_storage.cc (the port shares no file
// with the JAX package), built with g++ at first use into
// mxnet_tpu_torch/_build/ by mxnet_tpu_torch/native/__init__.py.
//
// Reference parity:
//  * Dependency engine — src/engine/threaded_engine.{h,cc}: ThreadedVar
//    read/write queues with version counters (threaded_engine.h:115-220),
//    OprBlock wait counts (threaded_engine.h:66-93), priority worker pool
//    (threaded_engine_perdevice.cc), exception capture per-var re-thrown at
//    WaitForVar/WaitForAll (threaded_engine.cc:429-481).
//  * Storage pool — src/storage/pooled_storage_manager.h: best-fit-by-size
//    (:52-129) and power-of-2 rounding (:190) managers, over HOST memory.
//
// Role: CUDA streams order device work; this engine orders HOST-side async
// tasks (record parsing, decode, checkpoint shards, python callbacks) with
// the read/write-var semantics the reference exposes through
// MXEnginePushAsync.
//
// C ABI (ctypes-consumed):
//   eng_create / eng_destroy
//   eng_new_var / eng_var_version / eng_del_var
//   eng_push (callback + const/mutable var lists + priority)
//   eng_wait_var / eng_wait_all   (return captured error, if any)
//   sto_create / sto_destroy / sto_alloc / sto_free / sto_stats /
//   sto_release_all

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// dependency engine
// ---------------------------------------------------------------------------

namespace {

typedef void (*TaskFn)(void* ctx, char** err_out);  // err_out: malloc'd or null

struct Opr;

struct PendingEntry {
  Opr* opr;
  bool is_write;
};

struct Var {
  std::deque<PendingEntry> queue;  // ops waiting on this var, FIFO
  int running_reads = 0;           // dispatched-but-unfinished readers
  bool writing = false;            // a writer is dispatched
  uint64_t version = 0;            // bumped on each completed write
  std::string error;               // first captured exception on this var
};

struct Opr {
  TaskFn fn;
  void* ctx;
  std::vector<uint64_t> const_vars;
  std::vector<uint64_t> mut_vars;
  int priority;
  std::atomic<int> wait_count{0};
  uint64_t seq;  // FIFO tiebreak within a priority class
};

struct OprCmp {
  bool operator()(Opr* a, Opr* b) const {
    if (a->priority != b->priority) return a->priority < b->priority;
    return a->seq > b->seq;  // lower seq first
  }
};

struct Engine {
  std::mutex mu;                       // protects vars, counters
  std::condition_variable cv_done;     // signaled on op completion
  std::unordered_map<uint64_t, Var> vars;
  uint64_t next_var = 1;
  uint64_t next_seq = 0;
  int inflight = 0;                    // pushed but not finished

  // worker pool
  std::mutex qmu;
  std::condition_variable qcv;
  std::priority_queue<Opr*, std::vector<Opr*>, OprCmp> ready;
  std::vector<std::thread> workers;
  bool stop = false;

  explicit Engine(int nworkers) {
    for (int i = 0; i < nworkers; ++i)
      workers.emplace_back([this] { WorkerLoop(); });
  }

  ~Engine() {
    {
      std::lock_guard<std::mutex> lk(qmu);
      stop = true;
    }
    qcv.notify_all();
    for (auto& t : workers) t.join();
    // drop any never-dispatched ops
    while (!ready.empty()) { delete ready.top(); ready.pop(); }
  }

  uint64_t NewVar() {
    std::lock_guard<std::mutex> lk(mu);
    uint64_t id = next_var++;
    vars.emplace(id, Var{});
    return id;
  }

  uint64_t VarVersion(uint64_t v) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = vars.find(v);
    return it == vars.end() ? 0 : it->second.version;
  }

  // Engine::DeleteVariable — blocks until pending ops on the var complete,
  // then reclaims it (the reference schedules an async delete; the observable
  // contract — all prior ops finish, then the var is gone — is the same).
  void DeleteVar(uint64_t v) {
    std::unique_lock<std::mutex> lk(mu);
    auto it = vars.find(v);
    if (it == vars.end()) return;
    Var* var = &it->second;
    cv_done.wait(lk, [var] {
      return var->queue.empty() && var->running_reads == 0 && !var->writing;
    });
    vars.erase(it);
  }

  // Returns true if the op may run now for this var, false if queued.
  bool TryAcquire(Var* var, Opr* opr, bool is_write) {
    if (is_write) {
      if (!var->writing && var->running_reads == 0 && var->queue.empty()) {
        var->writing = true;
        return true;
      }
    } else {
      if (!var->writing && var->queue.empty()) {
        ++var->running_reads;
        return true;
      }
    }
    var->queue.push_back(PendingEntry{opr, is_write});
    return false;
  }

  void Push(TaskFn fn, void* ctx, const uint64_t* cvars, int nc,
            const uint64_t* mvars, int nm, int priority) {
    Opr* opr = new Opr();
    opr->fn = fn;
    opr->ctx = ctx;
    opr->const_vars.assign(cvars, cvars + nc);
    opr->mut_vars.assign(mvars, mvars + nm);
    opr->priority = priority;
    {
      std::lock_guard<std::mutex> lk(mu);
      opr->seq = next_seq++;
      ++inflight;
      // dedup (a var both read and written counts once, as write)
      std::sort(opr->mut_vars.begin(), opr->mut_vars.end());
      opr->mut_vars.erase(
          std::unique(opr->mut_vars.begin(), opr->mut_vars.end()),
          opr->mut_vars.end());
      std::sort(opr->const_vars.begin(), opr->const_vars.end());
      opr->const_vars.erase(
          std::unique(opr->const_vars.begin(), opr->const_vars.end()),
          opr->const_vars.end());
      opr->const_vars.erase(
          std::remove_if(opr->const_vars.begin(), opr->const_vars.end(),
                         [&](uint64_t v) {
                           return std::binary_search(opr->mut_vars.begin(),
                                                     opr->mut_vars.end(), v);
                         }),
          opr->const_vars.end());

      int waits = 0;
      for (uint64_t v : opr->const_vars)
        if (!TryAcquire(&vars[v], opr, false)) ++waits;
      for (uint64_t v : opr->mut_vars)
        if (!TryAcquire(&vars[v], opr, true)) ++waits;
      opr->wait_count.store(waits + 1);  // +1 sentinel released below
    }
    DecWait(opr);  // release sentinel; dispatches if all deps already held
  }

  void DecWait(Opr* opr) {
    if (opr->wait_count.fetch_sub(1) == 1) {
      {
        std::lock_guard<std::mutex> lk(qmu);
        ready.push(opr);
      }
      qcv.notify_one();
    }
  }

  // After a queued op's dependency releases: grant next holders of the var.
  void Grant(Var* var) {
    while (!var->queue.empty()) {
      PendingEntry e = var->queue.front();
      if (e.is_write) {
        if (!var->writing && var->running_reads == 0) {
          var->queue.pop_front();
          var->writing = true;
          DecWait(e.opr);
        }
        break;  // writer blocks everything behind it
      }
      if (var->writing) break;
      var->queue.pop_front();
      ++var->running_reads;
      DecWait(e.opr);
    }
  }

  void Finish(Opr* opr, const char* err) {
    std::lock_guard<std::mutex> lk(mu);
    for (uint64_t vid : opr->const_vars) {
      Var& var = vars[vid];
      --var.running_reads;
      if (err && var.error.empty()) var.error = err;
      Grant(&var);
    }
    for (uint64_t vid : opr->mut_vars) {
      Var& var = vars[vid];
      var.writing = false;
      ++var.version;
      if (err && var.error.empty()) var.error = err;
      Grant(&var);
    }
    --inflight;
    cv_done.notify_all();
  }

  void WorkerLoop() {
    for (;;) {
      Opr* opr;
      {
        std::unique_lock<std::mutex> lk(qmu);
        qcv.wait(lk, [this] { return stop || !ready.empty(); });
        if (stop && ready.empty()) return;
        opr = ready.top();
        ready.pop();
      }
      char* err = nullptr;
      opr->fn(opr->ctx, &err);
      Finish(opr, err);
      if (err) free(err);
      delete opr;
    }
  }

  // Block until every op that touches `v` (pushed before this call) is done.
  // Returns captured error (caller must free) or nullptr.
  char* WaitVar(uint64_t v) {
    std::unique_lock<std::mutex> lk(mu);
    auto it = vars.find(v);
    if (it == vars.end()) return nullptr;
    Var* var = &it->second;
    cv_done.wait(lk, [var] {
      return var->queue.empty() && var->running_reads == 0 && !var->writing;
    });
    if (!var->error.empty()) {
      char* out = strdup(var->error.c_str());
      var->error.clear();  // reference clears after surfacing
      return out;
    }
    return nullptr;
  }

  char* WaitAll() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return inflight == 0; });
    for (auto& kv : vars) {
      if (!kv.second.error.empty()) {
        char* out = strdup(kv.second.error.c_str());
        kv.second.error.clear();
        return out;
      }
    }
    return nullptr;
  }
};

// ---------------------------------------------------------------------------
// pooled storage manager
// ---------------------------------------------------------------------------

struct StoragePool {
  // pool_type: 0 = naive (no pooling), 1 = best-fit by exact rounded size,
  // 2 = power-of-2 rounding (GPUPooledRoundedStorageManager)
  int pool_type;
  size_t page_size;        // round-up granularity for type 1
  size_t cap_bytes;        // keep at most this many pooled bytes (0 = inf)
  std::mutex mu;
  std::multimap<size_t, void*> pool;  // rounded size -> free block
  std::unordered_map<void*, size_t> sizes;  // live + pooled rounded sizes
  size_t pooled_bytes = 0;
  size_t live_bytes = 0;
  uint64_t n_alloc = 0, n_hit = 0;

  size_t Round(size_t s) const {
    if (pool_type == 2) {
      size_t r = 32;
      while (r < s) r <<= 1;
      return r;
    }
    size_t pg = page_size ? page_size : 4096;
    return ((s + pg - 1) / pg) * pg;
  }

  void* Alloc(size_t size) {
    size_t r = Round(size);
    std::lock_guard<std::mutex> lk(mu);
    ++n_alloc;
    if (pool_type != 0) {
      auto it = pool.lower_bound(r);
      if (it != pool.end() && (pool_type == 2 ? it->first == r
                                              : it->first <= r * 2)) {
        void* p = it->second;
        size_t got = it->first;
        pool.erase(it);
        pooled_bytes -= got;
        live_bytes += got;
        sizes[p] = got;
        ++n_hit;
        return p;
      }
    }
    void* p = nullptr;
    if (posix_memalign(&p, 64, r) != 0) return nullptr;
    live_bytes += r;
    sizes[p] = r;
    return p;
  }

  void Free(void* p) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = sizes.find(p);
    if (it == sizes.end()) return;
    size_t r = it->second;
    live_bytes -= r;
    if (pool_type == 0 || (cap_bytes && pooled_bytes + r > cap_bytes)) {
      sizes.erase(it);
      free(p);
      return;
    }
    pooled_bytes += r;
    pool.emplace(r, p);
  }

  void ReleaseAll() {
    std::lock_guard<std::mutex> lk(mu);
    for (auto& kv : pool) {
      sizes.erase(kv.second);
      free(kv.second);
    }
    pool.clear();
    pooled_bytes = 0;
  }

  ~StoragePool() {
    for (auto& kv : sizes) free(kv.first);
  }
};

}  // namespace

extern "C" {

void* eng_create(int nworkers) {
  if (nworkers <= 0) nworkers = 4;
  return new Engine(nworkers);
}

void eng_destroy(void* h) { delete static_cast<Engine*>(h); }

uint64_t eng_new_var(void* h) { return static_cast<Engine*>(h)->NewVar(); }

uint64_t eng_var_version(void* h, uint64_t v) {
  return static_cast<Engine*>(h)->VarVersion(v);
}

void eng_del_var(void* h, uint64_t v) {
  static_cast<Engine*>(h)->DeleteVar(v);
}

void eng_push(void* h, TaskFn fn, void* ctx, const uint64_t* cvars, int nc,
              const uint64_t* mvars, int nm, int priority) {
  static_cast<Engine*>(h)->Push(fn, ctx, cvars, nc, mvars, nm, priority);
}

// returns malloc'd error string or nullptr; caller frees via eng_free_str
char* eng_wait_var(void* h, uint64_t v) {
  return static_cast<Engine*>(h)->WaitVar(v);
}

char* eng_wait_all(void* h) { return static_cast<Engine*>(h)->WaitAll(); }

void eng_free_str(char* s) { free(s); }

void* sto_create(int pool_type, uint64_t page_size, uint64_t cap_bytes) {
  StoragePool* p = new StoragePool();
  p->pool_type = pool_type;
  p->page_size = page_size;
  p->cap_bytes = cap_bytes;
  return p;
}

void sto_destroy(void* h) { delete static_cast<StoragePool*>(h); }

void* sto_alloc(void* h, uint64_t size) {
  return static_cast<StoragePool*>(h)->Alloc(size);
}

void sto_free(void* h, void* p) { static_cast<StoragePool*>(h)->Free(p); }

void sto_release_all(void* h) { static_cast<StoragePool*>(h)->ReleaseAll(); }

// out[0]=live_bytes out[1]=pooled_bytes out[2]=n_alloc out[3]=n_hit
void sto_stats(void* h, uint64_t* out) {
  StoragePool* p = static_cast<StoragePool*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  out[0] = p->live_bytes;
  out[1] = p->pooled_bytes;
  out[2] = p->n_alloc;
  out[3] = p->n_hit;
}

}  // extern "C"
