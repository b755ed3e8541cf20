// Native cluster-scheduling core: the head's per-lease placement decision.
//
// Ref analog: src/ray/raylet/scheduling/cluster_resource_scheduler.h:44
// (GetBestSchedulableNode) + policy/hybrid_scheduling_policy.h:50 and the
// fixed-point resource vectors of cluster_resource_data.h / fixed_point.h.
// The Python ClusterResourceScheduler keeps policy-rich bundle placement;
// this core answers the hot single-task question — feasibility scan +
// utilization ranking over the whole node table — in C so a 10k-node
// table costs tens of microseconds, not milliseconds, per lease.
//
// Resource kinds are int64 ids interned by the Python side. Ids 0..4
// (CPU, GPU, TPU, memory, object_store_memory) are "predefined" and live
// in flat per-node arrays (the scan is cache-linear); of those, ids 0..3
// drive the hybrid policy's max-utilization, mirroring
// NodeResources.utilization(). Custom kinds ride a small sorted vector.
// Quantities are 1/10000 fixed-point int64, mirroring resources.py.
//
// Build: ray_tpu_torch/native/build.py -> libsched_core.so

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kPredef = 5;          // flat-array kinds (ids 0..4)
constexpr int kCriticalKinds = 4;   // CPU, GPU, TPU, memory drive util

struct Node {
  int64_t idx = -1;  // -1 marks a free slot
  int64_t avail[kPredef] = {0};
  int64_t total[kPredef] = {0};
  std::vector<std::pair<int64_t, int64_t>> custom_avail;  // sorted by kind
  std::vector<std::pair<int64_t, int64_t>> custom_total;
  bool draining = false;
};

struct Sched {
  std::vector<Node> slots;                     // contiguous scan target
  std::unordered_map<int64_t, size_t> by_idx;  // idx -> slot
  std::vector<size_t> free_slots;
};

struct Demand {
  int64_t predef[kPredef];
  const int64_t* kinds;
  const int64_t* amounts;
  int n;
  bool has_custom;
};

Demand parse_demand(int n, const int64_t* kinds, const int64_t* amounts) {
  Demand d{{0, 0, 0, 0, 0}, kinds, amounts, n, false};
  for (int i = 0; i < n; ++i) {
    if (kinds[i] >= 0 && kinds[i] < kPredef)
      d.predef[kinds[i]] = amounts[i];
    else if (amounts[i] > 0)
      d.has_custom = true;
  }
  return d;
}

int64_t custom_get(const std::vector<std::pair<int64_t, int64_t>>& v,
                   int64_t kind) {
  auto it = std::lower_bound(
      v.begin(), v.end(), kind,
      [](const std::pair<int64_t, int64_t>& p, int64_t k) {
        return p.first < k;
      });
  return (it != v.end() && it->first == kind) ? it->second : 0;
}

bool covers(const Node& node, const Demand& d, bool use_total) {
  const int64_t* have = use_total ? node.total : node.avail;
  for (int k = 0; k < kPredef; ++k)
    if (d.predef[k] > have[k]) return false;
  if (d.has_custom) {
    const auto& customs = use_total ? node.custom_total : node.custom_avail;
    for (int i = 0; i < d.n; ++i) {
      if (d.kinds[i] < kPredef || d.amounts[i] == 0) continue;
      if (custom_get(customs, d.kinds[i]) < d.amounts[i]) return false;
    }
  }
  return true;
}

double utilization(const Node& n) {
  double util = 0.0;
  for (int k = 0; k < kCriticalKinds; ++k) {
    if (n.total[k] == 0) continue;
    double u = 1.0 - static_cast<double>(n.avail[k]) /
                         static_cast<double>(n.total[k]);
    if (u > util) util = u;
  }
  return util;
}

uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s ? *s : 0x9e3779b97f4a7c15ULL;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  *s = x;
  return x;
}

}  // namespace

extern "C" {

void* sched_create() { return new Sched(); }

void sched_destroy(void* h) { delete static_cast<Sched*>(h); }

// Replace (or insert) a node's full resource state.
void sched_set_node(void* h, int64_t idx, int n, const int64_t* kinds,
                    const int64_t* avail, const int64_t* total) {
  Sched* s = static_cast<Sched*>(h);
  size_t slot;
  auto it = s->by_idx.find(idx);
  if (it != s->by_idx.end()) {
    slot = it->second;
  } else if (!s->free_slots.empty()) {
    slot = s->free_slots.back();
    s->free_slots.pop_back();
    s->by_idx[idx] = slot;
  } else {
    slot = s->slots.size();
    s->slots.emplace_back();
    s->by_idx[idx] = slot;
  }
  Node& node = s->slots[slot];
  node = Node{};
  node.idx = idx;
  for (int i = 0; i < n; ++i) {
    if (kinds[i] >= 0 && kinds[i] < kPredef) {
      node.avail[kinds[i]] = avail[i];
      node.total[kinds[i]] = total[i];
    } else {
      node.custom_avail.emplace_back(kinds[i], avail[i]);
      node.custom_total.emplace_back(kinds[i], total[i]);
    }
  }
  std::sort(node.custom_avail.begin(), node.custom_avail.end());
  std::sort(node.custom_total.begin(), node.custom_total.end());
}

void sched_remove_node(void* h, int64_t idx) {
  Sched* s = static_cast<Sched*>(h);
  auto it = s->by_idx.find(idx);
  if (it == s->by_idx.end()) return;
  s->slots[it->second] = Node{};  // idx = -1: skipped by scans
  s->free_slots.push_back(it->second);
  s->by_idx.erase(it);
}

void sched_set_draining(void* h, int64_t idx, int draining) {
  Sched* s = static_cast<Sched*>(h);
  auto it = s->by_idx.find(idx);
  if (it != s->by_idx.end())
    s->slots[it->second].draining = draining != 0;
}

int64_t sched_node_count(void* h) {
  return static_cast<int64_t>(static_cast<Sched*>(h)->by_idx.size());
}

// strategy: 0 = hybrid (local preference below threshold, then top-k
// least-utilized at random), 1 = spread (least utilized, ties by idx).
// threshold/topk_frac are 1/10000 fixed point. rng_state is in/out so
// the caller owns determinism. Returns node idx or -1.
int64_t sched_best_node(void* h, int n, const int64_t* kinds,
                        const int64_t* demand, int strategy,
                        int64_t local_idx, int64_t threshold_fp,
                        int64_t topk_frac_fp, uint64_t* rng_state) {
  Sched* s = static_cast<Sched*>(h);
  Demand d = parse_demand(n, kinds, demand);
  struct Cand {
    double util;
    int64_t idx;
  };
  std::vector<Cand> feasible;
  feasible.reserve(s->by_idx.size());
  for (const Node& node : s->slots) {
    if (node.idx < 0 || node.draining) continue;
    if (!covers(node, d, /*use_total=*/false)) continue;
    feasible.push_back({utilization(node), node.idx});
  }
  if (feasible.empty()) return -1;

  if (strategy == 1) {  // spread: min (util, idx)
    const Cand* best = &feasible[0];
    for (const Cand& c : feasible)
      if (c.util < best->util || (c.util == best->util && c.idx < best->idx))
        best = &c;
    return best->idx;
  }

  // hybrid: local node wins while its utilization is below threshold
  double threshold = static_cast<double>(threshold_fp) / 10000.0;
  for (const Cand& c : feasible)
    if (c.idx == local_idx && c.util < threshold) return local_idx;

  std::sort(feasible.begin(), feasible.end(),
            [](const Cand& a, const Cand& b) {
              return a.util != b.util ? a.util < b.util : a.idx < b.idx;
            });
  size_t k = static_cast<size_t>(
      feasible.size() * (static_cast<double>(topk_frac_fp) / 10000.0));
  if (k < 1) k = 1;
  if (k > feasible.size()) k = feasible.size();
  return feasible[xorshift(rng_state) % k].idx;
}

// 1 if any non-draining node's TOTAL covers the demand (feasibility, not
// current availability) — mirrors is_feasible_anywhere.
int sched_feasible_anywhere(void* h, int n, const int64_t* kinds,
                            const int64_t* demand) {
  Sched* s = static_cast<Sched*>(h);
  Demand d = parse_demand(n, kinds, demand);
  for (const Node& node : s->slots) {
    if (node.idx < 0 || node.draining) continue;
    if (covers(node, d, /*use_total=*/true)) return 1;
  }
  return 0;
}

}  // extern "C"
