/* Core-percentage pacing arithmetic of the CUDA interposer: a pure
 * function of (times, quota), so that the CPU tests drive it with
 * made-up times through the exported vgpu_pace_* calls.
 *
 * The rule is the port's (vtpu_torch/shim/runtime.py, ShimRuntime._pace):
 * hold the tenant's device-resident share of the wall clock at q %.  A
 * CUDA launch returns before its work runs, so the reference's sleep of
 * T * (100 - q) / q before each launch lets the duty climb towards
 * min(1, q / (100 - q)); a deadline does not.
 *
 * Device-resident time comes from completion events (as pace_observe in
 * cpp/vtpu_shim.cc takes it): a batch of launches whose first launch was
 * submitted at t_submit and whose event completed at t_complete ran from
 * start = max(t_submit, the previous completion) to t_complete (work of
 * one tenant is queue-ordered).  Each observed batch moves the deadline:
 *
 *     next_ok = max(next_ok, start) + busy * 100 / q
 *
 * and a launch waits until next_ok.  A saturating tenant's batches start
 * back to back, so next_ok grows by busy * 100 / q per busy: duty q %.
 * A tenant that idles finds next_ok in the past and max() restarts the
 * schedule from its own start: no credit is banked across idle time.
 * Observation lags the launches, so a paced tenant also waits while more
 * than VGPU_PACE_MAX_AHEAD batches are in flight unobserved: otherwise
 * the work it queues before its first completion would run as a burst
 * at full duty.  Times are seconds on CLOCK_MONOTONIC. */
#ifndef VTPU_PACE_H_
#define VTPU_PACE_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct vgpu_pace {
  double next_ok;       /* no launch before this time */
  double last_complete; /* the latest completion observed */
  double busy_s;        /* device-resident seconds observed in all */
} vgpu_pace;

/* one observed batch; returns its device-resident seconds.  q outside
 * (0, 100) observes without moving the deadline (no pacing). */
static inline double vgpu_pace_observe_inline(vgpu_pace* p, double t_submit,
                                              double t_complete, int q) {
  double start = t_submit > p->last_complete ? t_submit : p->last_complete;
  double busy = t_complete - start;
  if (busy < 0) busy = 0;
  if (t_complete > p->last_complete) p->last_complete = t_complete;
  p->busy_s += busy;
  if (q > 0 && q < 100) {
    double base = p->next_ok > start ? p->next_ok : start;
    p->next_ok = base + busy * 100.0 / q;
  }
  return busy;
}

#define VGPU_PACE_MAX_AHEAD 2     /* batches in flight, unobserved */
#define VGPU_PACE_POLL_S 100e-6    /* ask again after this long */

/* seconds a launch at `now` must wait before it may go (0: go), with
 * `in_flight` batches launched and not yet observed, at quota q; q
 * outside (0, 100) never waits.  While too many batches are in flight the
 * answer is VGPU_PACE_POLL_S: wait for a completion, then ask again. */
static inline double vgpu_pace_wait_inline(const vgpu_pace* p, double now,
                                           int in_flight, int q) {
  if (q <= 0 || q >= 100) return 0.0;
  if (in_flight > VGPU_PACE_MAX_AHEAD) return VGPU_PACE_POLL_S;
  return p->next_ok > now ? p->next_ok - now : 0.0;
}

/* the quota to pace to from the configured one, the core policy and the
 * region's utilization_switch (vtpu_torch.monitor.shared_region
 * .effective_core_limit): 1 suspends pacing unless the policy is force
 * (1); 2..4 halve the quota per level, from 100 for a tenant without
 * one, unless the policy is disable (2), which never paces.  Returns 0
 * for "do not pace". */
static inline int vgpu_pace_quota_inline(int core_limit, int policy,
                                         int utilization_switch) {
  if (policy == 2) return 0;
  if (utilization_switch == 1)
    return (policy == 1 && core_limit > 0 && core_limit < 100) ? core_limit
                                                                : 0;
  if (utilization_switch >= 2) {
    int level = utilization_switch > 4 ? 4 : utilization_switch;
    int base = (core_limit > 0 && core_limit < 100) ? core_limit : 100;
    int q = base >> (level - 1);
    return q < 1 ? 1 : q;
  }
  return (core_limit > 0 && core_limit < 100) ? core_limit : 0;
}

#ifdef __cplusplus
}
#endif

#endif /* VTPU_PACE_H_ */
