// Fused rigid-body substep, one group of LANES threads per env.
//
// Replaces ddiffpg_tpu/physics/pallas_ant.py:make_substep_kernel (the Pallas
// TPU kernel launched at pallas_ant.py:789) for its whole model class: FREE
// roots, HINGE/SLIDE/FIXED joints anchored at the body origin with several
// roots allowed, torque motors and gravity-compensated PD position servos,
// sphere/capsule probes against the ground plane, static AABBs and dynamic
// (body-attached) OBBs. It computes what that kernel's substep_math
// computes, in the same stage order and with the same summation order as
// the plain PyTorch version in physics/substep.py:
//   FK -> robot-centred frame -> motion subspaces and body velocities ->
//   6x6 inertias -> probe contacts vs plane and static AABBs (separation
//   gate, impulse cap) -> per-body impulse and global thrust budgets ->
//   dynamic OBBs with their reaction on the box body (stage g) ->
//   RNEA bias -> servo gravity compensation -> CRBA -> servos, motors,
//   damping, limit springs -> Cholesky solve -> semi-implicit integration
//   with clamps and inelastic limit stops.
// physics/substep.py:check_supported guards the class. The Panda builds
// (HAS_SERVO) carry two more entries after substep_kernel: ee_state_kernel,
// the end effector's position and velocity from the substep's first
// phases, and dls_ik_kernel, the `ee` control's damped-least-squares IK
// (physics/panda.py:Arm.dls_ik), whose iterations run the same FK phases.
//
// Design. An env's work is spread over a group of LANES threads (8, 16 or
// 32, a compile-time define; physics/substep_cuda.py:lanes_for picks 16,
// the fastest of the three for the ant, DrawerMulti and Reach on an H100,
// and 32 only where 16 slices would not fit a block) and its whole state
// lives in shared memory, one Slice per group; GROUPS groups make a block
// of 256 threads. The block first copies the model constants into shared
// memory, so a lane that reads its own probe's or body's constants does
// not serialise the warp, and reads at one index across lanes (the box
// loop's box_min[j]) are broadcasts. A substep is a fixed sequence of
// phases, each a function of (model, the group's Slice, lane), separated by
// __syncwarp over the group's lanes; lanes exchange data only through the
// Slice and keep nothing in registers from one phase to the next, so the
// host C++ build (-DSUBSTEP_HOST, tests/test_torch_substep_host.py) runs
// the same phases lane by lane between the barriers. Who does what:
//   per probe: the contacts (stage e), each walking the plane and then the
//     boxes j = 0..NSB-1 in order; per (box, probe) pair: stage g's tests,
//     then per probe its forces over boxes and per box its reaction over
//     probes, both in index order;
//   per body: hinge rotations, subspaces, impulse budgets (probes in index
//     order), external forces (reactions, then probes, in index order);
//   per (body, row): inertias and the I6 products of RNEA and gravity
//     compensation; per entry: the 36 composite-inertia sums (children in
//     reverse body order); per row of M: F6 and the row's entries, and
//     the torques of one dof;
//   per column of the Cholesky factor, one phase: its entries (left-looking,
//     each entry's subtractions in column order, then its scaling) and the
//     forward solve's entry of that column;
//   per spatial component: the tree walks of velocities, RNEA accelerations
//     and the backward force sums, each in body order;
//   one lane: FK (a chain through the tree), the thrust budget, the back
//     substitution; per dof and per body: integration.
// Every element gets the same operations in the same order as in the one
// thread per env version it replaces, so the outputs are bit for bit that
// version's. The NSUB substeps run inside the one launch; qpos,
// qvel and ctrl are read from device memory once and qpos, qvel written
// once.
//
// What bounds it: the work is scalar fp32 per env (1.1e4 to 7.1e4
// elementwise ops per substep, Panda Reach to the ant), parallel across
// the ant's 25 probes and narrow in the Panda trees (9-15 bodies, a serial
// FK and back substitution), and an H100 holds only ~31 envs per SM at
// 4096 envs, so the kernel is bound by the latency of each group's
// dependent chains and by issue slots, not by bytes (12-36x its operation
// bound; PERF.md). At 16 lanes a Slice is 3,936 bytes for the ant and
// 5,904 for DrawerMulti, a block 66,000 and 97,312 bytes; ptxas gives the
// ant 66 registers, DrawerMulti 80, Reach 70, each a 104-byte stack frame
// and no spills (CUDA 12.8). Not used, and why: tensor cores (wgmma, mma)
// would take the 3x3 and 6x6 products in TF32, and reduced precision is
// what broke the contact Cholesky on the TPU; TMA and cp.async have
// nothing to overlap (an ant env reads 148 bytes and writes 116);
// clusters, because an env's work fits in one group.
//
// Numerics: every literal carries an f suffix (no fp64 promotion); built
// without --use_fast_math and with -fmad=false, so each a*b+c rounds twice
// as in the plain version. min/max propagate NaN like torch/jnp so broken
// states stay non-finite.

#ifdef SUBSTEP_HOST
// host C++ build: CUDA qualifiers empty, the lanes of a group run in turn
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <string.h>
#else
#include <cuda_runtime.h>
#include <math.h>
#endif

#if !defined(NB) || !defined(NV) || !defined(NQ) || !defined(NU) || \
    !defined(NPR) || !defined(NSB) || !defined(NDB) || !defined(NSUB) || \
    !defined(HAS_SERVO) || !defined(LANES) || !defined(GROUPS)
#error "NB, NV, NQ, NU, NPR, NSB, NDB, NSUB, HAS_SERVO, LANES and GROUPS must be defined"
#endif
#if LANES != 8 && LANES != 16 && LANES != 32
#error "LANES must be 8, 16 or 32"
#endif
#define BLOCK_THREADS (GROUPS * LANES)
#define NSB_ALLOC (NSB > 0 ? NSB : 1)
#define NDB_ALLOC (NDB > 0 ? NDB : 1)
#define NLT (NV * (NV + 1) / 2)

enum { J_FREE = 0, J_HINGE = 1, J_SLIDE = 2, J_FIXED = 3 };

// All members are 4 bytes wide, so the layout has no padding; the ctypes
// mirror in physics/substep_cuda.py lists the same fields in this order.
struct SubstepModel {
  int parent[NB];
  int jnt_type[NB];
  int qposadr[NB];
  int dofadr[NB];
  int ident_quat[NB];
  int anc_mask[NB];
  float axis[NB][3];
  float body_pos[NB][3];
  float body_quat[NB][4];
  float mass[NB];
  float com[NB][3];
  float inertia[NB][3][3];
  float damping[NV];
  float armature[NV];
  float lim_lo[NV];
  float lim_hi[NV];
  int lim_on[NV];
  int dof_body[NV];
  int act_dof[NU];
  float act_gear[NU];
  int act_type[NU];
  float act_kp[NU];
  float act_kd[NU];
  float act_force[NU];
  int act_qadr[NU];
  int probe_body[NPR];
  float probe_off[NPR][3];
  float probe_rad[NPR];
  float probe_fric[NPR];
  float probe_kn[NPR];
  float probe_cn[NPR];
  float box_min[NSB_ALLOC][3];
  float box_max[NSB_ALLOC][3];
  int dbox_body[NDB_ALLOC];
  int dbox_ident[NDB_ALLOC];
  float dbox_pos[NDB_ALLOC][3];
  float dbox_quat[NDB_ALLOC][4];
  float dbox_half[NDB_ALLOC][3];
  float dbox_keep[NDB_ALLOC][NPR];  // 0 for the box body's own probes
  float gravity[3];
  float dt, inv_nb, capk_scale, inv_vreb, vreb, vtol, vtol_eps, lim_k, lim_c,
      vmax, support_f, m_total, inv_m_total;
};

// One env's state, in shared memory. Spatial vectors are float[6] (angular,
// linear). Only floats, so its size is 4 x the count that
// physics/substep_cuda.py:slice_floats computes. The union holds what is
// live in one span of the substep only.
struct Slice {
  float q[NQ], qd[NV], ctrl[NU];
  float pos[NB][3], quat[NB][4], posr[NB][3], p0[3];
  float S[NV][6], u[NV], V[NB][6];
  float I6[NB][6][6];  // inertias, then composite inertias
  float s_up;
  float fext[NB][6], A[NB][6], fb[NB][6];
  float rhs[NV];
#if HAS_SERVO
  float tau_grav[NV];
#endif
  union {
    float qj[NB][4];  // FK: each hinge's rotation
    struct {          // contacts, until the external forces are summed
      float fx[NPR], fy[NPR], fz[NPR], imp[NPR], vmin[NPR], pr[NPR][3];
#if NDB > 0
      float pwa[NPR][3], vva[NPR][3];
      float G[NDB][NPR][3];  // stage g: force of box j on probe k
      float rn[NDB][3], rf[NDB][3];
#endif
    } c;
    struct {  // RNEA
      float cm[NB][6], IA[NB][6], IV[NB][6];
    } r;
    struct {  // CRBA, solve, integration
      float L[NLT], dg[NV], y[NV], ud[NV], un[NV];  // dg: L's diagonal
    } k;
#if HAS_SERVO
    struct {  // dls_ik_kernel: the ee point and the Jacobian's columns (by
              // body); never the union's largest member (RNEA's is 18 NB)
      float p[3], J[NB][3];
    } ik;
#endif
  } w;
};

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct SV {  // spatial vector: angular, linear
  V3 a, l;
};

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN-propagating, like torch.maximum
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
__device__ __forceinline__ void st3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
__device__ __forceinline__ Q4 ldq(const float* p) {
  Q4 r;
  r.w = p[0];
  r.x = p[1];
  r.y = p[2];
  r.z = p[3];
  return r;
}
__device__ __forceinline__ void stq(float* p, Q4 q) {
  p[0] = q.w;
  p[1] = q.x;
  p[2] = q.y;
  p[3] = q.z;
}
__device__ __forceinline__ SV ldsv(const float* p) {
  SV r;
  r.a = ld3(p);
  r.l = ld3(p + 3);
  return r;
}
__device__ __forceinline__ void stsv(float* p, SV v) {
  st3(p, v.a);
  st3(p + 3, v.l);
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  Q4 r;
  r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
  r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
  r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
  r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
  return r;
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = mk(q.x, q.y, q.z);
  V3 t = vscale(vcross(qv, v), 2.0f);
  return vadd(vadd(v, vscale(t, q.w)), vcross(qv, t));
}
__device__ __forceinline__ SV sv_add(SV a, SV b) {
  SV r;
  r.a = vadd(a.a, b.a);
  r.l = vadd(a.l, b.l);
  return r;
}
__device__ __forceinline__ SV sv_scale(SV a, float s) {
  SV r;
  r.a = vscale(a.a, s);
  r.l = vscale(a.l, s);
  return r;
}
__device__ __forceinline__ SV cross_motion(SV v, SV m) {
  SV r;
  r.a = vcross(v.a, m.a);
  r.l = vadd(vcross(v.a, m.l), vcross(v.l, m.a));
  return r;
}
__device__ __forceinline__ SV cross_force(SV v, SV f) {
  SV r;
  r.a = vadd(vcross(v.a, f.a), vcross(v.l, f.l));
  r.l = vcross(v.a, f.l);
  return r;
}
// row r of a 6x6 block times a spatial vector, summed in column order
__device__ __forceinline__ float i6row(const float blk[6][6], int r,
                                       const float a[6]) {
  float acc = blk[r][0] * a[0];
#pragma unroll
  for (int c = 1; c < 6; ++c) acc = acc + blk[r][c] * a[c];
  return acc;
}

// Penalty normal force with separation gate and impulse cap, regularised
// Coulomb friction on the (relative) velocity v (pallas_ant.py:387-406,
// 545-560). Returns the force; f_n is the normal impulse rate.
__device__ __forceinline__ V3 penalty_force(const SubstepModel& m, float dist,
                                            V3 n, V3 v, float kn, float cn,
                                            float fric, float& f_n,
                                            float& pen) {
  pen = maxp(-dist, 0.0f);
  const float v_n = v.x * n.x + v.y * n.y + v.z * n.z;
  f_n = maxp(kn * pen - cn * v_n, 0.0f);
  f_n = pen > 0.0f ? f_n : 0.0f;
  f_n = f_n * clipp(1.0f - v_n * m.inv_vreb, 0.0f, 1.0f);
  const float cap_k = kn * m.capk_scale;
  f_n = minp(f_n, maxp(cap_k * (m.vreb - v_n), 0.0f));
  const float tx = v.x - v_n * n.x;
  const float ty = v.y - v_n * n.y;
  const float tz = v.z - v_n * n.z;
  const float vt = sqrtf(tx * tx + ty * ty + tz * tz + m.vtol_eps);
  const float scale = minp(vt / m.vtol, 1.0f);
  const float ft = -fric * f_n * scale / vt;
  return mk(f_n * n.x + ft * tx, f_n * n.y + ft * ty, f_n * n.z + ft * tz);
}

struct Contact {
  float fx, fy, fz, fn, vn_body;
};

// World contact: also the body's normal velocity for the impulse budget.
__device__ __forceinline__ Contact contact_force(const SubstepModel& m,
                                                 float dist, V3 n, V3 v, V3 vb,
                                                 float kn, float cn,
                                                 float fric) {
  float f_n, pen;
  const V3 f = penalty_force(m, dist, n, v, kn, cn, fric, f_n, pen);
  const float v_cn = vb.x * n.x + vb.y * n.y + vb.z * n.z;
  Contact r;
  r.fx = f.x;
  r.fy = f.y;
  r.fz = f.z;
  r.fn = f_n;
  r.vn_body = pen > 0.0f ? v_cn : 1e9f;  // sentinel: not in contact
  return r;
}

// Nearest face of a box from its six face distances (-x, +x, -y, +y, -z,
// +z), first in face order on ties: returns the distance, sets the normal.
__device__ __forceinline__ float nearest_face(const float fl[6], float ni[3]) {
  float d_in = fl[0];
#pragma unroll
  for (int f = 1; f < 6; ++f) d_in = minp(d_in, fl[f]);
  ni[0] = ni[1] = ni[2] = 0.0f;
  bool chosen = false;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const bool hit = (fl[f] <= d_in) && !chosen;
    if (hit) {
      ni[0] = ni[1] = ni[2] = 0.0f;
      ni[f >> 1] = (f & 1) ? 1.0f : -1.0f;
    }
    chosen = chosen || hit;
  }
  return d_in;
}

__device__ __forceinline__ bool one_dof(int t) {
  return t == J_HINGE || t == J_SLIDE;
}
__device__ __forceinline__ int lt(int i, int j) { return i * (i + 1) / 2 + j; }

// A phase: the work items i = lane, lane + LANES, ... of n.
#define FOR_LANE(i, n) for (int i = lane; i < (n); i += LANES)
#define PHASE_ARGS const SubstepModel &m, Slice &s, int lane

// ---------------- a. FK
// each hinge's rotation about its axis
__device__ void ph_hinge_rot(PHASE_ARGS) {
  FOR_LANE(i, NB) {
    if (m.jnt_type[i] != J_HINGE) continue;
    const float half = s.q[m.qposadr[i]] * 0.5f;
    const float sn = sinf(half);
    Q4 qj;
    qj.w = cosf(half);
    qj.x = m.axis[i][0] * sn;
    qj.y = m.axis[i][1] * sn;
    qj.z = m.axis[i][2] * sn;
    stq(s.w.qj[i], qj);
  }
}

// the walk in body order (FREE roots; HINGE, SLIDE, FIXED anywhere; other
// roots keep their constant frame), then the body centroid p0 (stage b).
// The last body's frame stays in registers: in a chain it is the parent.
__device__ void ph_fk(PHASE_ARGS) {
  if (lane != 0) return;
  V3 pos_i = mk(0.0f, 0.0f, 0.0f);
  Q4 quat_i = ldq(m.body_quat[0]);
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int t = m.jnt_type[i], qa = m.qposadr[i];
    if (t == J_FREE) {
      pos_i = mk(s.q[qa], s.q[qa + 1], s.q[qa + 2]);
      quat_i = ldq(s.q + qa + 3);
    } else {
      const int p = m.parent[i];
      V3 p0;
      Q4 q0;
      if (p >= 0) {
        V3 pp = pos_i;
        Q4 qp = quat_i;
        if (p != i - 1) {
          pp = ld3(s.pos[p]);
          qp = ldq(s.quat[p]);
        }
        p0 = vadd(pp, qrot(qp, ld3(m.body_pos[i])));
        q0 = qp;
        if (!m.ident_quat[i]) q0 = qmul(qp, ldq(m.body_quat[i]));
      } else {
        p0 = ld3(m.body_pos[i]);
        q0 = ldq(m.body_quat[i]);
      }
      if (t == J_HINGE) {
        quat_i = qmul(q0, ldq(s.w.qj[i]));
        pos_i = p0;
      } else if (t == J_SLIDE) {
        pos_i = vadd(p0, vscale(qrot(q0, ld3(m.axis[i])), s.q[qa]));
        quat_i = q0;
      } else {  // FIXED
        pos_i = p0;
        quat_i = q0;
      }
    }
    st3(s.pos[i], pos_i);
    stq(s.quat[i], quat_i);
  }
  V3 c0 = ld3(s.pos[0]);
  for (int i = 1; i < NB; ++i) c0 = vadd(c0, ld3(s.pos[i]));
  st3(s.p0, vscale(c0, m.inv_nb));
}

// ---------------- b, c. robot-centred positions, motion subspaces, qvel -> u
__device__ void ph_subspace(PHASE_ARGS) {
  const V3 zero3 = mk(0.0f, 0.0f, 0.0f);
  FOR_LANE(i, NB) {
    const V3 posr = vsub(ld3(s.pos[i]), ld3(s.p0));
    st3(s.posr[i], posr);
    const int t = m.jnt_type[i], d = m.dofadr[i];
    if (t == J_FREE) {
      for (int k = 0; k < 3; ++k) {
        float e[3] = {0.0f, 0.0f, 0.0f};
        e[k] = 1.0f;
        st3(s.S[d + k], zero3);
        st3(s.S[d + k] + 3, mk(e[0], e[1], e[2]));
        st3(s.S[d + 3 + k], mk(e[0], e[1], e[2]));
        st3(s.S[d + 3 + k] + 3, zero3);
      }
      const float* qd = s.qd;
      const V3 vo = vsub(mk(qd[d], qd[d + 1], qd[d + 2]),
                         vcross(mk(qd[d + 3], qd[d + 4], qd[d + 5]), posr));
      s.u[d] = vo.x;
      s.u[d + 1] = vo.y;
      s.u[d + 2] = vo.z;
      for (int k = 3; k < 6; ++k) s.u[d + k] = qd[d + k];
    } else if (one_dof(t)) {
      s.u[d] = s.qd[d];
      const V3 w = qrot(ldq(s.quat[i]), ld3(m.axis[i]));
      if (t == J_HINGE) {
        st3(s.S[d], w);
        st3(s.S[d] + 3, vcross(posr, w));
      } else {
        st3(s.S[d], zero3);
        st3(s.S[d] + 3, w);
      }
    }
  }
}

// ---------------- c. body spatial velocities: a walk in body order, one
// lane per component
__device__ __forceinline__ void ph_velocity(PHASE_ARGS) {
  if (lane < 6) {
    const int c = lane;
    float v = 0.0f;  // V[i-1][c]
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
      const int t = m.jnt_type[i], d = m.dofadr[i], p = m.parent[i];
      float base = 0.0f;
      if (p >= 0) base = p == i - 1 ? v : s.V[p][c];
      if (t == J_FREE)
        v = c < 3 ? s.u[d + 3 + c] : s.u[d + c - 3];
      else if (one_dof(t))
        v = base + s.S[d][c] * s.u[d];
      else  // FIXED: the parent's motion
        v = base;
      s.V[i][c] = v;
    }
  }
}

// the velocities, then d. 6x6 spatial inertias about p0, one item per
// (body, row r), which writes rows r and 3 + r
__device__ void ph_velocity_inertia(PHASE_ARGS) {
  ph_velocity(m, s, lane);
  FOR_LANE(it, NB * 3) {
    const int i = it / 3, r = it - 3 * i;
    const Q4 qq = ldq(s.quat[i]);
    const float w = qq.w, x = qq.x, y = qq.y, z = qq.z;
    const float R[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
         2.0f * (x * z + w * y)},
        {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
         2.0f * (y * z - w * x)},
        {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
         1.0f - 2.0f * (x * x + y * y)}};
    const float* cm = m.com[i];
    float Rc[3];
    for (int k = 0; k < 3; ++k)
      Rc[k] = R[k][0] * cm[0] + R[k][1] * cm[1] + R[k][2] * cm[2];
    const V3 cc = vadd(ld3(s.posr[i]), mk(Rc[0], Rc[1], Rc[2]));
    float RI[3], Ic[3];
    for (int k = 0; k < 3; ++k)
      RI[k] = R[r][0] * m.inertia[i][0][k] + R[r][1] * m.inertia[i][1][k] +
              R[r][2] * m.inertia[i][2][k];
    for (int k = 0; k < 3; ++k)
      Ic[k] = RI[0] * R[k][0] + RI[1] * R[k][1] + RI[2] * R[k][2];
    const float mi = m.mass[i];
    const float cx[3][3] = {{0.0f, -cc.z, cc.y}, {cc.z, 0.0f, -cc.x},
                            {-cc.y, cc.x, 0.0f}};
    for (int k = 0; k < 3; ++k) {
      const float cxcx =
          cx[r][0] * cx[0][k] + cx[r][1] * cx[1][k] + cx[r][2] * cx[2][k];
      s.I6[i][r][k] = Ic[k] - mi * cxcx;
      s.I6[i][r][3 + k] = mi * cx[r][k];
      s.I6[i][3 + r][k] = -mi * cx[r][k];
      s.I6[i][3 + r][3 + k] = r == k ? 0.0f + mi : 0.0f;
    }
  }
}

// ---------------- e. contacts: each probe vs the plane, then the static
// boxes in order
__device__ void ph_contacts(PHASE_ARGS) {
  const V3 p0 = ld3(s.p0);
  FOR_LANE(k, NPR) {
    const int b = m.probe_body[k];
    const V3 posr = ld3(s.posr[b]), Va = ld3(s.V[b]), Vl = ld3(s.V[b] + 3);
    const V3 rq = qrot(ldq(s.quat[b]), ld3(m.probe_off[k]));
    const V3 pw = vadd(ld3(s.pos[b]), rq);
    const V3 vv = vadd(Vl, vcross(Va, vadd(posr, rq)));
    const V3 vb = vadd(Vl, vcross(Va, posr));
    st3(s.w.c.pr[k], vsub(pw, p0));  // torque arm about p0
#if NDB > 0
    st3(s.w.c.pwa[k], pw);
    st3(s.w.c.vva[k], vv);
#endif
    const float rad = m.probe_rad[k], fric = m.probe_fric[k];
    const float kn = m.probe_kn[k], cn = m.probe_cn[k];

    Contact cf = contact_force(m, pw.z - rad, mk(0.0f, 0.0f, 1.0f), vv, vb,
                               kn, cn, fric);
    float afx = cf.fx, afy = cf.fy, afz = cf.fz, aimp = cf.fn,
          avmin = cf.vn_body;
#pragma unroll 1
    for (int j = 0; j < NSB; ++j) {
      const V3 bmin = ld3(m.box_min[j]);
      const V3 bmax = ld3(m.box_max[j]);
      const float dx = pw.x - clipp(pw.x, bmin.x, bmax.x);
      const float dy = pw.y - clipp(pw.y, bmin.y, bmax.y);
      const float dz = pw.z - clipp(pw.z, bmin.z, bmax.z);
      const float d_out = sqrtf(dx * dx + dy * dy + dz * dz);
      const bool outside = d_out > 1e-9f;
      const float inv = 1.0f / (outside ? d_out : 1.0f);
      const float fl[6] = {pw.x - bmin.x, bmax.x - pw.x, pw.y - bmin.y,
                           bmax.y - pw.y, pw.z - bmin.z, bmax.z - pw.z};
      float ni[3];
      const float d_in = nearest_face(fl, ni);
      const V3 n = outside ? mk(dx * inv, dy * inv, dz * inv)
                           : mk(ni[0], ni[1], ni[2]);
      const float dist = (outside ? d_out : -d_in) - rad;
      const Contact g = contact_force(m, dist, n, vv, vb, kn, cn, fric);
      afx = afx + g.fx;
      afy = afy + g.fy;
      afz = afz + g.fz;
      aimp = aimp + g.fn;
      avmin = minp(avmin, g.vn_body);
    }
    s.w.c.fx[k] = afx;
    s.w.c.fy[k] = afy;
    s.w.c.fz[k] = afz;
    s.w.c.imp[k] = aimp;
    s.w.c.vmin[k] = avmin;
  }
}

// ---------------- f. per-body world-contact impulse budget, probes in index
// order
__device__ void ph_budget(PHASE_ARGS) {
  FOR_LANE(b, NB) {
    float imp_b = 0.0f, vmin_b = 0.0f;
    bool any = false;
#pragma unroll
    for (int k = 0; k < NPR; ++k) {
      if (m.probe_body[k] != b) continue;
      if (!any) {
        imp_b = s.w.c.imp[k];
        vmin_b = s.w.c.vmin[k];
        any = true;
      } else {
        imp_b = imp_b + s.w.c.imp[k];
        vmin_b = minp(vmin_b, s.w.c.vmin[k]);
      }
    }
    if (!any) continue;
    const float fade_b = clipp(1.0f - vmin_b * m.inv_vreb, 0.0f, 1.0f);
    const float allow_b = m.support_f * fade_b +
                          m.mass[b] * maxp(m.vreb - vmin_b, 0.0f) / m.dt;
    const float s_b = minp(allow_b / maxp(imp_b, 1e-9f), 1.0f);
#pragma unroll
    for (int k = 0; k < NPR; ++k) {
      if (m.probe_body[k] != b) continue;
      s.w.c.fx[k] = s.w.c.fx[k] * s_b;
      s.w.c.fy[k] = s.w.c.fy[k] * s_b;
      s.w.c.fz[k] = s.w.c.fz[k] * s_b;
    }
  }
}

// global vertical-thrust budget against the COM vertical velocity (one lane)
__device__ void ph_thrust(PHASE_ARGS) {
  if (lane != 0) return;
  float vz_com = 0.0f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float vb_z =
        vadd(ld3(s.V[b] + 3), vcross(ld3(s.V[b]), ld3(s.posr[b]))).z;
    const float term = vb_z * m.mass[b];
    vz_com = b == 0 ? term : vz_com + term;
  }
  vz_com = vz_com * m.inv_m_total;
  const float up_fade = clipp(1.0f - vz_com * m.inv_vreb, 0.0f, 1.0f);
  const float allow_up = m.support_f * up_fade +
                         m.m_total * maxp(m.vreb - vz_com, 0.0f) / m.dt;
  float f_up = maxp(s.w.c.fz[0], 0.0f);
#pragma unroll
  for (int k = 1; k < NPR; ++k) f_up = f_up + maxp(s.w.c.fz[k], 0.0f);
  s.s_up = minp(allow_up / maxp(f_up, 1e-9f), 1.0f);
}

#if NDB > 0
// ---------------- g. dynamic OBBs, after both budgets: probes in the box
// frame against the box (pallas_ant.py:500-586). First the thrust budget
// on each probe, and each (box j, probe k) pair's force into G
__device__ void ph_dbox_pairs(PHASE_ARGS) {
  FOR_LANE(k, NPR) {
    const float fz = s.w.c.fz[k];
    s.w.c.fz[k] = fz > 0.0f ? fz * s.s_up : fz;
  }
  FOR_LANE(it, NDB * NPR) {
    const int j = it / NPR, k = it - NPR * j;
    const int b2 = m.dbox_body[j];
    const V3 half = ld3(m.dbox_half[j]);
    const Q4 qb2 = ldq(s.quat[b2]);
    Q4 bq = qb2;
    if (!m.dbox_ident[j]) bq = qmul(qb2, ldq(m.dbox_quat[j]));
    const V3 bp = vadd(ld3(s.pos[b2]), qrot(qb2, ld3(m.dbox_pos[j])));
    Q4 cbq = bq;
    cbq.x = -bq.x;
    cbq.y = -bq.y;
    cbq.z = -bq.z;
    const SV Vb = ldsv(s.V[b2]);
    const V3 l = qrot(cbq, vsub(ld3(s.w.c.pwa[k]), bp));
    const float dx = l.x - clipp(l.x, -half.x, half.x);
    const float dy = l.y - clipp(l.y, -half.y, half.y);
    const float dz = l.z - clipp(l.z, -half.z, half.z);
    const float d_out = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool outside = d_out > 1e-9f;
    const float inv = 1.0f / (outside ? d_out : 1.0f);
    const float fl[6] = {l.x + half.x, half.x - l.x, l.y + half.y,
                         half.y - l.y, l.z + half.z, half.z - l.z};
    float ni[3];
    const float d_in = nearest_face(fl, ni);
    const V3 n = qrot(bq, outside ? mk(dx * inv, dy * inv, dz * inv)
                                  : mk(ni[0], ni[1], ni[2]));
    const float dist = (outside ? d_out : -d_in) - m.probe_rad[k];
    // relative velocity: probe minus the box body's point velocity
    const V3 r = ld3(s.w.c.pr[k]);
    const V3 vbp = mk(Vb.l.x + Vb.a.y * r.z - Vb.a.z * r.y,
                      Vb.l.y + Vb.a.z * r.x - Vb.a.x * r.z,
                      Vb.l.z + Vb.a.x * r.y - Vb.a.y * r.x);
    float f_n, pen;
    const V3 g0 =
        penalty_force(m, dist, n, vsub(ld3(s.w.c.vva[k]), vbp),
                      m.probe_kn[k], m.probe_cn[k], m.probe_fric[k], f_n, pen);
    st3(s.w.c.G[j][k], vscale(g0, m.dbox_keep[j][k]));
  }
}

// each probe's forces over boxes in j order; each box's reaction sums
// (torque about p0, force) over probes in probe order
__device__ void ph_dbox_sums(PHASE_ARGS) {
  FOR_LANE(k, NPR) {
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const V3 g = ld3(s.w.c.G[j][k]);
      s.w.c.fx[k] = s.w.c.fx[k] + g.x;
      s.w.c.fy[k] = s.w.c.fy[k] + g.y;
      s.w.c.fz[k] = s.w.c.fz[k] + g.z;
    }
  }
  FOR_LANE(j, NDB) {
    V3 rn = mk(0.0f, 0.0f, 0.0f), rf = rn;
#pragma unroll
    for (int k = 0; k < NPR; ++k) {
      const V3 g = ld3(s.w.c.G[j][k]);
      const V3 no = vcross(ld3(s.w.c.pr[k]), g);
      rn = k == 0 ? no : vadd(rn, no);
      rf = k == 0 ? g : vadd(rf, g);
    }
    st3(s.w.c.rn[j], rn);
    st3(s.w.c.rf[j], rf);
  }
}
#define FZ_UP(k) s.w.c.fz[k]
#else
#define FZ_UP(k) (s.w.c.fz[k] > 0.0f ? s.w.c.fz[k] * s.s_up : s.w.c.fz[k])
#endif

// external forces on each body about p0: the dynamic boxes' reactions in
// box order, then its probes' forces in probe order
__device__ void ph_fext(PHASE_ARGS) {
  const V3 zero3 = mk(0.0f, 0.0f, 0.0f);
  FOR_LANE(b, NB) {
    SV fe;
    fe.a = zero3;
    fe.l = zero3;
#if NDB > 0
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      if (m.dbox_body[j] != b) continue;
      fe.a = vadd(fe.a, vsub(zero3, ld3(s.w.c.rn[j])));
      fe.l = vadd(fe.l, vsub(zero3, ld3(s.w.c.rf[j])));
    }
#endif
#pragma unroll
    for (int k = 0; k < NPR; ++k) {
      if (m.probe_body[k] != b) continue;
      SV f;
      f.l = mk(s.w.c.fx[k], s.w.c.fy[k], FZ_UP(k));
      f.a = vcross(ld3(s.w.c.pr[k]), f.l);
      fe = sv_add(fe, f);
    }
    stsv(s.fext[b], fe);
  }
}
#undef FZ_UP

// ---------------- h. bias forces (RNEA, qacc = 0)
// the velocity-product term of each one-dof body's acceleration
__device__ void ph_rnea_cm(PHASE_ARGS) {
  FOR_LANE(i, NB) {
    const int p = m.parent[i], t = m.jnt_type[i], d = m.dofadr[i];
    if (p < 0 || !one_dof(t)) continue;
    stsv(s.w.r.cm[i],
         cross_motion(ldsv(s.V[p]), sv_scale(ldsv(s.S[d]), s.u[d])));
  }
}

// accelerations: a walk in body order, one lane per component
__device__ void ph_rnea_acc(PHASE_ARGS) {
  if (lane >= 6) return;
  const int c = lane;
  const float a0 = c < 3 ? 0.0f : 0.0f - m.gravity[c - 3];
  float a = a0;  // A[i-1][c]
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int p = m.parent[i], t = m.jnt_type[i];
    if (p < 0 || t == J_FREE) {
      a = a0;
    } else {
      const float ap = p == i - 1 ? a : s.A[p][c];
      a = one_dof(t) ? ap + s.w.r.cm[i][c] : ap;  // FIXED: the parent's
    }
    s.A[i][c] = a;
  }
}

// I6 A and I6 V, one item per (body, row)
__device__ void ph_rnea_i6(PHASE_ARGS) {
  FOR_LANE(it, NB * 6) {
    const int i = it / 6, r = it - 6 * i;
    s.w.r.IA[i][r] = i6row(s.I6[i], r, s.A[i]);
    s.w.r.IV[i][r] = i6row(s.I6[i], r, s.V[i]);
  }
}

__device__ void ph_rnea_net(PHASE_ARGS) {
  FOR_LANE(i, NB) {
    const SV net = sv_add(ldsv(s.w.r.IA[i]),
                          cross_force(ldsv(s.V[i]), ldsv(s.w.r.IV[i])));
    const SV fe = ldsv(s.fext[i]);
    st3(s.fb[i], vsub(net.a, fe.a));
    st3(s.fb[i] + 3, vsub(net.l, fe.l));
  }
}

// Subtree sums of x[0..NB-1] (stride `stride` floats), children in reverse
// body order: x[p] += x[i]. The entry written last stays in a register.
__device__ __forceinline__ void subtree_sums(const SubstepModel& m, float* x,
                                             int stride) {
  int wp = -1;  // the entry written last, and its value
  float wv = 0.0f;
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = m.parent[i];
    if (p < 0) continue;
    const float xi = wp == i ? wv : x[i * stride];
    const float xp = wp == p ? wv : x[p * stride];
    wv = xp + xi;
    wp = p;
    x[p * stride] = wv;
  }
}

// subtree sums of fb, one lane per component
__device__ void ph_backward(PHASE_ARGS) {
  if (lane < 6) subtree_sums(m, &s.fb[0][lane], 6);
}

// S^T fb per dof: the bias torques into rhs, or (servo) the gravity torques
__device__ __forceinline__ float s_dot_fb(const SubstepModel& m,
                                          const Slice& s, int d) {
  const SV f = ldsv(s.fb[m.dof_body[d]]);
  const SV S = ldsv(s.S[d]);
  return vdot(S.a, f.a) + vdot(S.l, f.l);
}
__device__ void ph_bias_torque(PHASE_ARGS) {
  FOR_LANE(d, NV) s.rhs[d] = s_dot_fb(m, s, d);  // tau_bias for now
}

#if HAS_SERVO
// ---------------- gravity compensation of the servos: the zero-velocity,
// no-contact RNEA, i.e. subtree sums of I6 a0 (pallas_ant.py:664-678);
// fb's storage is reused, RNEA is done
__device__ void ph_grav_i6(PHASE_ARGS) {
  const float a0[6] = {0.0f, 0.0f, 0.0f, 0.0f - m.gravity[0],
                       0.0f - m.gravity[1], 0.0f - m.gravity[2]};
  FOR_LANE(it, NB * 6) {
    const int i = it / 6, r = it - 6 * i;
    s.fb[i][r] = i6row(s.I6[i], r, a0);
  }
}
__device__ void ph_grav_torque(PHASE_ARGS) {
  FOR_LANE(d, NV) s.tau_grav[d] = s_dot_fb(m, s, d);
}
#endif

// ---------------- CRBA: composite inertias in place of I6 (RNEA is done),
// one lane per entry
__device__ void ph_composite(PHASE_ARGS) {
  FOR_LANE(e, 36) subtree_sums(m, &s.I6[0][0][0] + e, 36);
}

// the lower triangle of M, one row d per item: F6 = I6c S[d] in registers,
// then the entries (d, e <= d); and the applied and passive torques of dof
// NV-1-d, so that the short rows take the torques: rhs = tau - tau_bias
__device__ void ph_crba_m(PHASE_ARGS) {
  FOR_LANE(d, NV) {
    const int bd = m.dof_body[d];
    float f6[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) f6[r] = i6row(s.I6[bd], r, s.S[d]);
    SV F6;
    F6.a = mk(f6[0], f6[1], f6[2]);
    F6.l = mk(f6[3], f6[4], f6[5]);
    float* Ld = s.w.k.L + lt(d, 0);
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      if (e > d) continue;
      float val = 0.0f;
      if ((m.anc_mask[bd] >> m.dof_body[e]) & 1) {
        const SV Se = ldsv(s.S[e]);
        val = vdot(Se.a, F6.a) + vdot(Se.l, F6.l);
        if (d == e) val = val + m.armature[d];
      }
      Ld[e] = val;
    }
    const int dd = NV - 1 - d;
    float tau = 0.0f - m.damping[dd] * s.u[dd];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      if (m.act_dof[a] != dd) continue;
#if HAS_SERVO
      if (m.act_type[a] == 1) {  // PD position servo, force-limited
        const float f = m.act_kp[a] * (s.ctrl[a] - s.q[m.act_qadr[a]]) -
                        m.act_kd[a] * s.u[dd] + s.tau_grav[dd];
        tau = tau + clipp(f, -m.act_force[a], m.act_force[a]);
        continue;
      }
#endif
      tau = tau + m.act_gear[a] * clipp(s.ctrl[a], -1.0f, 1.0f);
    }
    const int i = m.dof_body[dd];  // limits: HINGE and SLIDE joints
    if (one_dof(m.jnt_type[i]) && m.lim_on[dd]) {
      const float qi = s.q[m.qposadr[i]];
      const float over = maxp(qi - m.lim_hi[dd], 0.0f);
      const float under = maxp(m.lim_lo[dd] - qi, 0.0f);
      const bool active = (over > 0.0f) || (under > 0.0f);
      tau = tau - m.lim_k * (over - under) -
            (active ? m.lim_c * s.u[dd] : 0.0f);
    }
    s.rhs[dd] = tau - s.rhs[dd];
  }
}

// x - sum_{j < n} a[j] b[j], subtracted in j order
__device__ __forceinline__ float sub_dot(float x, const float* a,
                                         const float* b, int n) {
#pragma unroll
  for (int j = 0; j < n; ++j) x = x - a[j] * b[j];
  return x;
}

// ---------------- j. Cholesky (dense, fixed order) with the forward solve,
// one phase per column c, left-looking: item 0 the diagonal (into dg, not
// L), items 1 .. NV-1-c the rows below it, the last item y[c]. Each entry
// gets the subtractions of columns j = 0 .. c-1 in j order and then the
// scaling, as in the right-looking loop it replaces; every item computes
// the column's diagonal itself, so no item waits for another. Inlined into
// the unrolled column loop, so c and every trip count are constants.
__device__ __forceinline__ void ph_chol_column(PHASE_ARGS, int c) {
  float* L = s.w.k.L;
  const float* Lc = L + lt(c, 0);  // row c
  FOR_LANE(t, NV - c + 1) {
    const float d = sub_dot(Lc[c], Lc, Lc, c);
    const float inv_dc = 1.0f / sqrtf(maxp(d, 1e-9f));
    const float dgc = d * inv_dc;
    if (t == 0) {
      s.w.k.dg[c] = dgc;
    } else if (c + t < NV) {
      const int i2 = c + t;
      const float* Li = L + lt(i2, 0);
      L[lt(i2, c)] = sub_dot(Li[c], Li, Lc, c) * inv_dc;
    } else {
      s.w.k.y[c] = sub_dot(s.rhs[c], Lc, s.w.k.y, c) / dgc;
    }
  }
}

// the back substitution, k2 in order, on one lane; unrolled, so that ud
// lives in registers
__device__ void ph_solve(PHASE_ARGS) {
  if (lane != 0) return;
  const float* L = s.w.k.L;
  float ud[NV];
#pragma unroll
  for (int i2 = NV - 1; i2 >= 0; --i2) {
    float acc = s.w.k.y[i2];
#pragma unroll
    for (int k2 = i2 + 1; k2 < NV; ++k2) acc = acc - L[lt(k2, i2)] * ud[k2];
    ud[i2] = acc / s.w.k.dg[i2];
  }
#pragma unroll
  for (int d = 0; d < NV; ++d) s.w.k.ud[d] = ud[d];
}

// ---------------- k. integrate (semi-implicit, hard velocity clamps): the
// clamped velocities per dof ...
__device__ void ph_velocity_update(PHASE_ARGS) {
  const float vmax = m.vmax;
  FOR_LANE(d, NV) {
    const float un = clipp(s.u[d] + m.dt * s.w.k.ud[d], -vmax, vmax);
    s.w.k.un[d] = un;
    s.qd[d] = un;
  }
}

// ... then positions per body
__device__ void ph_position_update(PHASE_ARGS) {
  const float dt = m.dt, vmax = m.vmax;
  const float* un = s.w.k.un;
  FOR_LANE(i, NB) {
    const int t = m.jnt_type[i], qa = m.qposadr[i], d = m.dofadr[i];
    float* q = s.q;
    if (t == J_FREE) {
      const V3 w_new = mk(un[d + 3], un[d + 4], un[d + 5]);
      V3 vp = vadd(mk(un[d], un[d + 1], un[d + 2]),
                   vcross(w_new, ld3(s.posr[i])));
      vp = mk(clipp(vp.x, -vmax, vmax), clipp(vp.y, -vmax, vmax),
              clipp(vp.z, -vmax, vmax));
      const float angle =
          sqrtf(w_new.x * w_new.x + w_new.y * w_new.y + w_new.z * w_new.z);
      const float safe = angle > 1e-9f ? angle : 1.0f;
      const float axx = w_new.x / safe, axy = w_new.y / safe,
                  axz = w_new.z / safe;
      const float half = angle * dt * 0.5f;
      const float sh = sinf(half);
      Q4 dq;
      dq.w = cosf(half);
      dq.x = axx * sh;
      dq.y = axy * sh;
      dq.z = axz * sh;
      const Q4 qn = qmul(dq, ldq(q + qa + 3));
      const float norm =
          sqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z);
      q[qa] = q[qa] + dt * vp.x;
      q[qa + 1] = q[qa + 1] + dt * vp.y;
      q[qa + 2] = q[qa + 2] + dt * vp.z;
      q[qa + 3] = qn.w / norm;
      q[qa + 4] = qn.x / norm;
      q[qa + 5] = qn.y / norm;
      q[qa + 6] = qn.z / norm;
      s.qd[d] = vp.x;
      s.qd[d + 1] = vp.y;
      s.qd[d + 2] = vp.z;
    } else if (one_dof(t)) {
      float qv = q[qa] + dt * un[d];
      float qdv = un[d];
      if (m.lim_on[d]) {  // inelastic limit stops
        const float lo = m.lim_lo[d], hi = m.lim_hi[d];
        qdv = qv < lo ? maxp(qdv, 0.0f) : qdv;
        qdv = qv > hi ? minp(qdv, 0.0f) : qdv;
        qv = clipp(qv, lo, hi);
      }
      q[qa] = qv;
      s.qd[d] = qdv;
    }
  }
}

// One substep of one env by its group: the phases in stage order, each
// followed by the group's barrier. The host build runs each phase for
// every lane in turn instead.
#ifdef SUBSTEP_HOST
#define PHASE(fn) \
  for (int l_ = 0; l_ < LANES; ++l_) fn(m, s, l_)
#define PHASE_J(fn, j) \
  for (int l_ = 0; l_ < LANES; ++l_) fn(m, s, l_, j)
#else
#define PHASE(fn)         \
  do {                    \
    fn(m, s, lane);       \
    __syncwarp(mask);     \
  } while (0)
#define PHASE_J(fn, j)    \
  do {                    \
    fn(m, s, lane, j);    \
    __syncwarp(mask);     \
  } while (0)
#endif

__device__ void substep_group(const SubstepModel& m, Slice& s, int lane,
                              unsigned mask) {
  (void)lane;
  (void)mask;
  PHASE(ph_hinge_rot);
  PHASE(ph_fk);
  PHASE(ph_subspace);
  PHASE(ph_velocity_inertia);
  PHASE(ph_contacts);
  PHASE(ph_budget);
  PHASE(ph_thrust);
#if NDB > 0
  PHASE(ph_dbox_pairs);
  PHASE(ph_dbox_sums);
#endif
  PHASE(ph_fext);
  PHASE(ph_rnea_cm);
  PHASE(ph_rnea_acc);
  PHASE(ph_rnea_i6);
  PHASE(ph_rnea_net);
  PHASE(ph_backward);
  PHASE(ph_bias_torque);
#if HAS_SERVO
  PHASE(ph_grav_i6);
  PHASE(ph_backward);
  PHASE(ph_grav_torque);
#endif
  PHASE(ph_composite);
  PHASE(ph_crba_m);
#pragma unroll
  for (int c = 0; c < NV; ++c) PHASE_J(ph_chol_column, c);
  PHASE(ph_solve);
  PHASE(ph_velocity_update);
  PHASE(ph_position_update);
}

// Shared memory of a block: the model, then GROUPS slices, each rounded up
// to 16 bytes.
#define ROUND16(n) (((n) + 15) / 16 * 16)
#define MODEL_BYTES ROUND16((int)sizeof(SubstepModel))
#define SLICE_BYTES ROUND16((int)sizeof(Slice))
#define SHARED_BYTES (MODEL_BYTES + GROUPS * SLICE_BYTES)

extern "C" int substep_model_bytes() { return (int)sizeof(SubstepModel); }
extern "C" int substep_shared_bytes() { return SHARED_BYTES; }

#ifdef SUBSTEP_HOST
// The host build's entry: every env of a batch, one after the other.
extern "C" void substep_host(const void* model, const float* qpos,
                             const float* qvel, const float* ctrl,
                             float* qpos_out, float* qvel_out, int B) {
  SubstepModel m;
  memcpy(&m, model, sizeof(SubstepModel));
  Slice s;
  for (int env = 0; env < B; ++env) {
    memcpy(s.q, qpos + (size_t)env * NQ, sizeof(s.q));
    memcpy(s.qd, qvel + (size_t)env * NV, sizeof(s.qd));
    memcpy(s.ctrl, ctrl + (size_t)env * NU, sizeof(s.ctrl));
    for (int t = 0; t < NSUB; ++t) substep_group(m, s, 0, 0u);
    memcpy(qpos_out + (size_t)env * NQ, s.q, sizeof(s.q));
    memcpy(qvel_out + (size_t)env * NV, s.qd, sizeof(s.qd));
  }
}
#else
__device__ SubstepModel c_m;  // uploaded once, when the library is loaded

// 256 threads a block; at least 32 envs a block set (LANES / 8 blocks of
// GROUPS envs), so that the registers of 32 envs fit on an SM.
__global__ void __launch_bounds__(BLOCK_THREADS, LANES / 8)
    substep_kernel(const float* __restrict__ qpos,
                   const float* __restrict__ qvel,
                   const float* __restrict__ ctrl,
                   float* __restrict__ qpos_out,
                   float* __restrict__ qvel_out, int B) {
  extern __shared__ float smem[];
  {
    const int* src = reinterpret_cast<const int*>(&c_m);
    int* dst = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < (int)(sizeof(SubstepModel) / 4);
         i += BLOCK_THREADS)
      dst[i] = src[i];
  }
  __syncthreads();
  const SubstepModel& m = *reinterpret_cast<const SubstepModel*>(smem);
  const int g = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int env = blockIdx.x * GROUPS + g;
  if (env >= B) return;  // the whole group: its env is past the batch
  Slice& s = *reinterpret_cast<Slice*>(reinterpret_cast<char*>(smem) +
                                       MODEL_BYTES + g * SLICE_BYTES);
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << (LANES & 31)) - 1u) << ((threadIdx.x & 31) &
                                                     ~(LANES - 1));
  FOR_LANE(k, NQ) s.q[k] = qpos[(size_t)env * NQ + k];
  FOR_LANE(k, NV) s.qd[k] = qvel[(size_t)env * NV + k];
  FOR_LANE(k, NU) s.ctrl[k] = ctrl[(size_t)env * NU + k];
  __syncwarp(mask);
#pragma unroll 1
  for (int t = 0; t < NSUB; ++t) substep_group(m, s, lane, mask);
  FOR_LANE(k, NQ) qpos_out[(size_t)env * NQ + k] = s.q[k];
  FOR_LANE(k, NV) qvel_out[(size_t)env * NV + k] = s.qd[k];
}
#endif

#if HAS_SERVO  // ---- the end-effector state
// A second entry, for the Panda builds only: the end effector's position
// and linear velocity of each env (envs/panda.py:PandaTaskEnv._ee_state),
// one launch a control step beside the substep's, in place of the ~900
// small PyTorch kernels of physics/engine.py:Kinematics (fk,
// dof_subspaces, qvel_to_u, body_velocities) and Arm.ee_position. It
// replaces no TPU kernel: the JAX package computes the ee state in XLA.
// It runs the substep's first phases on the same model block, Slice and
// group of lanes (hinge rotations, FK, motion subspaces, the velocity
// walk), then lane 0 writes [p_ee, v_ee]:
//   p_ee = pos[hand] + rotate(quat[hand], off)
//   v_ee = V[hand].l + V[hand].a x (p_ee - p0)
// The subspaces are taken about the body centroid p0, as the substep's
// (Kinematics takes them about the world origin), so V[hand]'s linear
// part is the velocity of the point at p0. Bound by the serial FK chain of
// each env (a few thousand flops an env, 24 bytes written). The substep
// kernel's preamble is written out again here: helpers shared by the two
// kernels gave substep_kernel other registers (ptxas, CUDA 12.8).
// EE_PHASE is PHASE under its own name, which tools/phase_clocks.py does
// not rewrite (it counts the substep's phases only).
#ifdef SUBSTEP_HOST
#define EE_PHASE(fn) \
  for (int l_ = 0; l_ < LANES; ++l_) fn(m, s, l_)
#else
#define EE_PHASE(fn)  \
  do {                \
    fn(m, s, lane);   \
    __syncwarp(mask); \
  } while (0)
#endif

__device__ void ee_state_group(const SubstepModel& m, Slice& s, int lane,
                               unsigned mask, int hand, V3 off, float* out) {
  (void)mask;
  EE_PHASE(ph_hinge_rot);
  EE_PHASE(ph_fk);
  EE_PHASE(ph_subspace);
  EE_PHASE(ph_velocity);
  if (lane != 0) return;
  const V3 p = vadd(ld3(s.pos[hand]), qrot(ldq(s.quat[hand]), off));
  const SV V = ldsv(s.V[hand]);
  st3(out, p);
  st3(out + 3, vadd(V.l, vcross(V.a, vsub(p, ld3(s.p0)))));
}

#ifdef SUBSTEP_HOST
extern "C" void ee_state_host(const void* model, const float* qpos,
                              const float* qvel, float* out, int hand,
                              float ox, float oy, float oz, int B) {
  SubstepModel m;
  memcpy(&m, model, sizeof(SubstepModel));
  Slice s;
  for (int env = 0; env < B; ++env) {
    memcpy(s.q, qpos + (size_t)env * NQ, sizeof(s.q));
    memcpy(s.qd, qvel + (size_t)env * NV, sizeof(s.qd));
    ee_state_group(m, s, 0, 0u, hand, mk(ox, oy, oz), out + (size_t)env * 6);
  }
}
#else
__global__ void __launch_bounds__(BLOCK_THREADS, LANES / 8)
    ee_state_kernel(const float* __restrict__ qpos,
                    const float* __restrict__ qvel, float* __restrict__ out,
                    int hand, float ox, float oy, float oz, int B) {
  extern __shared__ float smem[];
  {
    const int* src = reinterpret_cast<const int*>(&c_m);
    int* dst = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < (int)(sizeof(SubstepModel) / 4);
         i += BLOCK_THREADS)
      dst[i] = src[i];
  }
  __syncthreads();
  const SubstepModel& m = *reinterpret_cast<const SubstepModel*>(smem);
  const int g = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int env = blockIdx.x * GROUPS + g;
  if (env >= B) return;
  Slice& s = *reinterpret_cast<Slice*>(reinterpret_cast<char*>(smem) +
                                       MODEL_BYTES + g * SLICE_BYTES);
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << (LANES & 31)) - 1u) << ((threadIdx.x & 31) &
                                                     ~(LANES - 1));
  FOR_LANE(k, NQ) s.q[k] = qpos[(size_t)env * NQ + k];
  FOR_LANE(k, NV) s.qd[k] = qvel[(size_t)env * NV + k];
  __syncwarp(mask);
  ee_state_group(m, s, lane, mask, hand, mk(ox, oy, oz),
                 out + (size_t)env * 6);
}

extern "C" int ee_state_launch(const float* qpos, const float* qvel,
                               float* out, int hand, float ox, float oy,
                               float oz, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + GROUPS - 1) / GROUPS;
  ee_state_kernel<<<blocks, BLOCK_THREADS, SHARED_BYTES,
                    (cudaStream_t)stream>>>(qpos, qvel, out, hand, ox, oy,
                                            oz, B);
  return (int)cudaGetLastError();
}
#endif
#endif  // HAS_SERVO: the end-effector state

#if HAS_SERVO  // ---- the DLS IK
// A third entry, for the Panda builds only: the `ee` control's
// damped-least-squares IK (physics/panda.py:Arm.dls_ik) and the end
// effector's point it starts from (Arm.ee_point), launched from there
// wherever the env steps through this kernel: two launches a control step
// (the point, then the IK) in place of some 3,500 small PyTorch kernels of
// Kinematics.fk, Arm.ee_jacobian and the 3x3 solves. It replaces no TPU
// kernel: the JAX package computes the IK in XLA.
//
// Each env is one group of LANES threads on its Slice, as in the other
// entries: it loads q, then for each of `iters` iterations (one pass with
// no step when `iters` is 0)
//   hinge rotations (per body), then FK of the hand's ancestors (lane 0);
//   p = pos[hand] + rotate(quat[hand], off), written out after the first
//     FK when asked (the point at qpos); per arm body k, in body order,
//     J_k = rotate(quat[k], axis[k]) x (p - pos[k]);
//   every lane: A = J J^T + damp2 I, with A's columns a0, a1, a2:
//     c0 = a1 x a2, c1 = a2 x a0, c2 = a0 x a1, det = a0 . c0,
//     x = [c0 . err, c1 . err, c2 . err] / det, err = target - p; then per
//     arm body k: q[qposadr[k]] += clip(J_k . x, -0.2, 0.2);
// and writes the arm's q. The arm is the bitmask `arm` of bodies (Arm's
// links, hinges), joint k its k-th set bit; `hand` and `off` name the end
// effector (the tcp, or PegInsertion's peg tip), so nothing branches on
// the task. Every lane computes the same solve from the same shared values,
// which saves the barrier one lane's solve would need before the steps.
//
// Numerics: the stiff, force-limited servos turn a one-ulp change of an arm
// target into an ee velocity a tenth apart one control step later (PERF.md),
// so the entry computes what the plain PyTorch computes on the card bit for
// bit, op for op in Kinematics.fk's and dls_ik's order, each op rounded as
// torch's kernel for it rounds: a cross product component is one fused
// multiply-add (ATen's cross kernel is built with contraction: tcross);
// J J^T is cuBLAS's chain of fused multiply-adds over k from zero; a sum of
// 3 elements adjacent in memory adds elements 0 and 2, then 1 (tsum3), and
// so does J^T x's sum over J's rows (J is a transposed view of the
// columns); everything else, one rounding an op (this file builds with
// -fmad=false). FK therefore has its own phase here (the substep's rotates
// with unfused cross products and skips identity rotations). The hinge
// axes are unit vectors, so Kinematics' normalisation of them is exact.
// Found with torch 2.11 and CUDA 12.8 on an H100; the card tests in
// tests/test_torch_cuda.py hold the entry to the plain route bit for bit,
// and fail where a later torch rounds otherwise.
//
// What bounds it: the serial FK chain of each env, `iters` times (~7,500
// flops an env for 3 iterations against ~100 bytes moved); one group an env
// keeps FK on the Slice and the substep's layout, and an env's IK has too
// little parallel work to spread wider. The preamble is written out again,
// as in ee_state_kernel; IK_PHASE is its own macro, which
// tools/phase_clocks.py does not rewrite.
#ifdef SUBSTEP_HOST
#define IK_PHASE(call) \
  for (int lane = 0; lane < LANES; ++lane) call
#else
#define IK_PHASE(call) \
  do {                 \
    call;              \
    __syncwarp(mask);  \
  } while (0)
#endif

// torch.linalg.cross on the card
__device__ __forceinline__ V3 tcross(V3 a, V3 b) {
  return mk(fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x)));
}
// physics/quat.py:rotate on the card
__device__ __forceinline__ V3 trot(Q4 q, V3 v) {
  const V3 qv = mk(q.x, q.y, q.z);
  const V3 t = vscale(tcross(qv, v), 2.0f);
  return vadd(vadd(v, vscale(t, q.w)), tcross(qv, t));
}
// (a * b).sum(-1) of rows of 3 on the card (its reduction's two
// accumulators)
__device__ __forceinline__ float tsum3(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}

// Kinematics.fk for the hand's ancestors, in body order
__device__ void ph_ik_fk(PHASE_ARGS, int hand) {
  if (lane != 0) return;
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    if (!((m.anc_mask[hand] >> i) & 1)) continue;
    const int t = m.jnt_type[i], qa = m.qposadr[i], p = m.parent[i];
    V3 pn;
    Q4 qn;
    if (t == J_FREE) {
      pn = mk(s.q[qa], s.q[qa + 1], s.q[qa + 2]);
      qn = ldq(s.q + qa + 3);
    } else {
      V3 pp = mk(0.0f, 0.0f, 0.0f);
      Q4 pq;
      pq.w = 1.0f;
      pq.x = pq.y = pq.z = 0.0f;
      if (p >= 0) {
        pp = ld3(s.pos[p]);
        pq = ldq(s.quat[p]);
      }
      pn = vadd(pp, trot(pq, ld3(m.body_pos[i])));
      qn = qmul(pq, ldq(m.body_quat[i]));
      if (t == J_HINGE)  // the anchor is the body origin: no shift
        qn = qmul(qn, ldq(s.w.qj[i]));
      else if (t == J_SLIDE)
        pn = vadd(pn, vscale(trot(qn, ld3(m.axis[i])), s.q[qa]));
    }
    st3(s.pos[i], pn);
    stq(s.quat[i], qn);
  }
}

// the end effector's point p (to p_out when given) and the arm's Jacobian
// columns
__device__ void ph_ik_jacobian(PHASE_ARGS, unsigned arm, int hand, V3 off,
                               float* p_out) {
  const V3 p = vadd(ld3(s.pos[hand]), trot(ldq(s.quat[hand]), off));
  if (lane == 0) {
    st3(s.w.ik.p, p);
    if (p_out) st3(p_out, p);
  }
  FOR_LANE(i, NB) {
    if (!((arm >> i) & 1u)) continue;
    const V3 w = trot(ldq(s.quat[i]), ld3(m.axis[i]));
    st3(s.w.ik.J[i], tcross(w, vsub(p, ld3(s.pos[i]))));
  }
}

// the damped 3x3 system solved in closed form, then each arm joint's step
__device__ void ph_ik_step(PHASE_ARGS, unsigned arm, const float* tgt,
                           float damp2) {
  float a[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    if (!((arm >> i) & 1u)) continue;
    const float* j = s.w.ik.J[i];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) a[r][c] = fmaf(j[r], j[c], a[r][c]);
  }
  for (int r = 0; r < 3; ++r) a[r][r] = a[r][r] + damp2;
  const V3 a0 = mk(a[0][0], a[1][0], a[2][0]);  // A's columns
  const V3 a1 = mk(a[0][1], a[1][1], a[2][1]);
  const V3 a2 = mk(a[0][2], a[1][2], a[2][2]);
  const V3 c0 = tcross(a1, a2), c1 = tcross(a2, a0), c2 = tcross(a0, a1);
  const float det = tsum3(a0, c0);
  const V3 err = vsub(ld3(tgt), ld3(s.w.ik.p));
  const V3 x = mk(tsum3(c0, err) / det, tsum3(c1, err) / det,
                  tsum3(c2, err) / det);
  FOR_LANE(i, NB) {
    if (!((arm >> i) & 1u)) continue;
    const int qa = m.qposadr[i];
    s.q[qa] = s.q[qa] + clipp(tsum3(ld3(s.w.ik.J[i]), x), -0.2f, 0.2f);
  }
}

__device__ void dls_ik_group(const SubstepModel& m, Slice& s, int lane,
                             unsigned mask, unsigned arm, int hand, V3 off,
                             const float* tgt, int iters, float damp2,
                             float* q_out, float* p_out) {
  (void)mask;
  const int passes = iters > 0 ? iters : 1;
#pragma unroll 1
  for (int it = 0; it < passes; ++it) {
    IK_PHASE(ph_hinge_rot(m, s, lane));
    IK_PHASE(ph_ik_fk(m, s, lane, hand));
    IK_PHASE(ph_ik_jacobian(m, s, lane, arm, hand, off,
                            it == 0 ? p_out : nullptr));
    if (it < iters) IK_PHASE(ph_ik_step(m, s, lane, arm, tgt, damp2));
  }
  if (lane != 0 || !q_out) return;
  int k = 0;
  for (int i = 0; i < NB; ++i)
    if ((arm >> i) & 1u) q_out[k++] = s.q[m.qposadr[i]];
}

// q_out [B, popcount(arm)] and p_out [B, 3] may each be null; target is
// read only when iters > 0.
#ifdef SUBSTEP_HOST
extern "C" void dls_ik_host(const void* model, const float* qpos,
                            const float* target, float* q_out, float* p_out,
                            unsigned arm, int hand, float ox, float oy,
                            float oz, int iters, float damp2, int B) {
  SubstepModel m;
  memcpy(&m, model, sizeof(SubstepModel));
  Slice s;
  const int n_arm = __builtin_popcount(arm);
  for (int env = 0; env < B; ++env) {
    memcpy(s.q, qpos + (size_t)env * NQ, sizeof(s.q));
    dls_ik_group(m, s, 0, 0u, arm, hand, mk(ox, oy, oz),
                 target ? target + (size_t)env * 3 : nullptr, iters, damp2,
                 q_out ? q_out + (size_t)env * n_arm : nullptr,
                 p_out ? p_out + (size_t)env * 3 : nullptr);
  }
}
#else
__global__ void __launch_bounds__(BLOCK_THREADS, LANES / 8)
    dls_ik_kernel(const float* __restrict__ qpos,
                  const float* __restrict__ target, float* __restrict__ q_out,
                  float* __restrict__ p_out, unsigned arm, int hand, float ox,
                  float oy, float oz, int iters, float damp2, int B) {
  extern __shared__ float smem[];
  {
    const int* src = reinterpret_cast<const int*>(&c_m);
    int* dst = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < (int)(sizeof(SubstepModel) / 4);
         i += BLOCK_THREADS)
      dst[i] = src[i];
  }
  __syncthreads();
  const SubstepModel& m = *reinterpret_cast<const SubstepModel*>(smem);
  const int g = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int env = blockIdx.x * GROUPS + g;
  if (env >= B) return;
  Slice& s = *reinterpret_cast<Slice*>(reinterpret_cast<char*>(smem) +
                                       MODEL_BYTES + g * SLICE_BYTES);
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << (LANES & 31)) - 1u) << ((threadIdx.x & 31) &
                                                     ~(LANES - 1));
  FOR_LANE(k, NQ) s.q[k] = qpos[(size_t)env * NQ + k];
  __syncwarp(mask);
  dls_ik_group(m, s, lane, mask, arm, hand, mk(ox, oy, oz),
               target ? target + (size_t)env * 3 : nullptr, iters, damp2,
               q_out ? q_out + (size_t)env * __popc(arm) : nullptr,
               p_out ? p_out + (size_t)env * 3 : nullptr);
}

extern "C" int dls_ik_launch(const float* qpos, const float* target,
                             float* q_out, float* p_out, unsigned arm,
                             int hand, float ox, float oy, float oz,
                             int iters, float damp2, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + GROUPS - 1) / GROUPS;
  dls_ik_kernel<<<blocks, BLOCK_THREADS, SHARED_BYTES,
                  (cudaStream_t)stream>>>(qpos, target, q_out, p_out, arm,
                                          hand, ox, oy, oz, iters, damp2, B);
  return (int)cudaGetLastError();
}
#endif
#endif  // HAS_SERVO: the DLS IK

#ifndef SUBSTEP_HOST
// ---------------------------------------------------------------------------
// plain C interface, bound with ctypes in physics/substep_cuda.py

// The dynamic shared memory of a block of `kernel`, and the largest shared
// carveout of an SM's 256 KB, so that the blocks of 32 envs (DrawerMulti:
// two of 95 KB) fit on one SM together rather than as CUDA's default
// carveout would have it.
static cudaError_t set_shared(const void* kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Uploads the model and sets each kernel's shared memory.
extern "C" int substep_set_model(const void* host_model) {
  cudaError_t err =
      cudaMemcpyToSymbol(c_m, host_model, sizeof(SubstepModel));
  if (err == cudaSuccess) err = set_shared((const void*)substep_kernel);
#if HAS_SERVO  // ---- the end-effector state
  if (err == cudaSuccess) err = set_shared((const void*)ee_state_kernel);
#endif  // HAS_SERVO: the end-effector state
#if HAS_SERVO  // ---- the DLS IK
  if (err == cudaSuccess) err = set_shared((const void*)dls_ik_kernel);
#endif  // HAS_SERVO: the DLS IK
  return (int)err;
}

extern "C" int substep_launch(const float* qpos, const float* qvel,
                              const float* ctrl, float* qpos_out,
                              float* qvel_out, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + GROUPS - 1) / GROUPS;
  substep_kernel<<<blocks, BLOCK_THREADS, SHARED_BYTES,
                   (cudaStream_t)stream>>>(qpos, qvel, ctrl, qpos_out,
                                           qvel_out, B);
  return (int)cudaGetLastError();
}

extern "C" const char* substep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
