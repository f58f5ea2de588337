"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``jiminy_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version, drives the flagship
ANYmal env step (B = 4096, 4 substeps of 5 ms, 8 PGS sweeps) through the
port's public entry points, and times the env step and each kernel. It
imports nothing of JAX and nothing of ``jiminy_tpu``. The kernels:

Every kernel runs one warp per env, the env's working set in shared
memory:

- K1 ``constraint_solve`` (``csrc/constraint_solve.cu``, the chain of
  ``csrc/solve_chain.cuh``): the solve chain;
- K2 ``substep_multi`` (``csrc/substep.cu``, the code in
  ``csrc/substep.cuh`` and its warp body ``csrc/substep_warp.cuh``, for
  every model): every substep of an env step in one launch, τ recomputed
  in-kernel;
- K3 ``substep`` (``csrc/substep.cu``, the same warp body): one substep,
  τ given;
- K2 with the sensor stage ``substep_multi_sensors`` (``csrc/substep.cu``,
  ``substep_multi_warp_kernel<true, false, false>``): the same, plus after every
  k_obs-th substep the sensor suite's update (measure at the accepted
  state, corrupt with pre-sampled eps, push the delay lines);
- the ground instantiations ``substep_ground``, ``substep_multi_ground``
  and ``substep_multi_sensors_ground`` (``GEN``): K3, K2 and K2 with the
  sensor stage on an analytic ground per env (Fourier, Perlin, Stairs),
  queried in-kernel from each env's coefficients (``jt_ground_query``),
  the contact rows and impulses in the basis of the ground's normal;
- the randomized instantiations ``rand_substep``, ``rand_substep_multi``,
  ``rand_substep_multi_sensors`` and their ``_ground`` twins
  (``csrc/substep_rand.cu``, ``RAND``): each env's row of packed model
  parameters in place of the baked inertials, armature and (K2) motor
  gain and friction;
- the same kernels on the Cassie biped (``cassie_substep``,
  ``cassie_substep_multi``, ``cassie_substep_multi_sensors`` in the
  kernels line): the large frame (nb ≤ 32, nv ≤ 32, nc ≤ 96; the warp
  body there too), the pushrods' distance
  rows ahead of the bounds and the shin springs, runtime branches of the
  same instantiations;
- the same kernels with collision pairs (``cassie_selfcol_substep_multi``,
  ``cassie_selfcol_substep``, ``pairs_ptbox_substep_multi``,
  ``pairs_ptseg_substep_multi``: the pair narrow phases ``seg``, ``ptbox``
  and ``ptseg`` and their contact rows, `jt_pair_item`) and with sphere
  contact sites (``sphere_sites_substep_multi``, ``…_ground``: the site
  offset before the contact Jacobians, on flat ground and with the
  two-pass ground query), runtime branches again;
- the same kernels on the flexible-hip Cassie (``cassie_flex_substep_multi``,
  ``cassie_flex_substep_multi_sensors``, ``cassie_flex_substep``): the
  SPHERICAL joints' branches and the springs' −k·log(quat)
  (`jt_quat_log`, `jt_quat_step`), runtime branches on the packed joint
  types;
- the same kernels with PRISMATIC joints (B.10: the slider's subspace [0;
  axis] and transform (I, axis·q), `JT_PRISMATIC`): on the cartpole
  (``cartpole_substep_multi``, ``cartpole_substep``) and on the
  reference's PRISMATIC kernel scene (``prismatic_slab_substep_multi``,
  ``prismatic_slab_substep``: tests/test_box_pairs.py's sprung slab and
  free cube with their box pair, nc 48);
- K2 and K2 with the sensor stage on the Ant and the Spotmicro
  (``ant_substep_multi``, ``ant_substep_multi_sensors``,
  ``spotmicro_substep_multi``, ``spotmicro_substep_multi_sensors``: 20
  substeps per env step; the Ant's sensor update every second substep);
- the kernels on the Atlas humanoid (A.23: ``atlas_substep_multi``,
  ``atlas_substep_multi_sensors``: nb 24, nv 29, nc 47, 5 substeps of 4
  ms) and on Atlas with its self-collision pairs
  (``atlas_selfcol_substep_multi``, ``atlas_selfcol_substep_multi_sensors``,
  ``atlas_selfcol_substep``, ``atlas_selfcol_constraint_solve``: nc 83,
  the largest frame, nc ≤ 96, six PGS colors, X's 84 right-hand sides
  and A's 83 columns three to a lane).

Phases (any failure raises and the script exits non-zero):

0. a CUDA GPU is present; card name and power limit; nvcc build time of
   every source and ptxas's registers, stack and spills;
1. every kernel against its plain version from the same inputs:
   - K1 on random SPD systems (ANYmal, Atlas, Cassie, gantry and wheel layouts, with and
     without the KKT residual; ANYmal at B = 4096 with 8 sweeps; a ragged
     B = 1000), max |Δ| ≤ 1e-4 on v⁺, λ and the residual, and at B = 4096
     a second launch bit-equal;
   - on every model (ANYmal flat, on each ground and randomized, sphere
     feet, the cartpole, the slab scenes nominal and randomized, the Ant,
     the Spotmicro, Cassie, its pair sets and flexible hips), K3 given
     K2's applied τ bit-equal to K2 at n_sub = 1 on q, v, λ, the residual
     and the impulses (`_k3_equals_k2`: one substep body);
   - K3 and K2 at n_sub = 1 against ``substep_reference`` /
     ``substep_multi_reference`` on perturbed ANYmal states with a root
     wrench (a quarter of them at joint limits), at B = 4096 and a ragged
     B = 1000: max |Δ| ≤ 1e-4 on q, v, λ, the impulses and the residual
     (f32 is well posed over one substep from these states);
   - K2 at n_sub = 4 (a whole env step): float32 rounding compounds over
     4 substeps for any two f32 implementations, so the yardstick is the
     plain version in float64, env by env (`_gate_vs_f64`);
   - K2 with the sensor stage (ANYmal's suite: IMU, 12 encoders, 12
     efforts, 4 contacts; delay 0.004 s, noise 0.02 / 0.005) against
     ``substep_multi_reference(..., sensors=...)`` on the same inputs,
     buffers and eps, with a quarter of the envs' bases turned half a
     turn about z (the IMU quaternion's w near 0): at n_sub = 1, B = 4096
     and a ragged B = 1000, q, v, λ within 1e-4, the buffers within 1e-4
     after scaling each reading by max(1, its largest value), and q, v, λ equal
     to the sensor-free K2's bit for bit; the stage alone, against the
     float64 plain stage from the kernel's own accepted state (its q⁺, v⁺,
     a, impulses and τ), element by element, |Δ| ≤ 1e-4·max(1, |value|);
     at n_sub = 4 env by env against
     the float64 plain version, buffers included; at k_obs = 2 (an update
     every other substep) through ``Engine.step_with_sensors``, likewise;
   - the three ground instantiations on each ground (a fresh ground per
     env, bases spread over ±2 m or the whole staircase and raised by the
     height under the feet; the number of contacts on a steep normal
     printed, and none on the stairs fails): at n_sub = 1, B = 4096 and a
     ragged B = 1000, within 1e-4 as above (each through its own launch
     counter; the sensor variant's physics bit-equal to the sensor-free
     one's); at n_sub = 4 env by env against the float64 plain version;
   - the randomized instantiations with parameters drawn over the slice's
     ranges widened to the armature and friction (a quarter of the envs at
     the ranges' ends; `_rand_params`): flat, at n_sub = 1 (B = 4096 and
     1000) within 1e-4 as above, on the Fourier ground env by env against
     float64, at n_sub = 4 env by env against float64; the nominal
     parameters within 1e-5 of the unrandomized kernels; one state with
     different parameters steps apart;
   - the Cassie spec (`phase_cassie_vs_plain`): K3, K2 and K2 with the
     sensor stage at n_sub = 1 (B = 4096 and 1000) held to the float64
     plain version by the distribution of the per-env distance
     (`_gate_dist_vs_f64`: Cassie's float32 is not well posed at 1e-4), τ
     within 1e-4 of its size, the sensor variant's physics bit-equal; K2
     over 10 substeps bit-equal to 10 chained launches; one randomized K2
     launch; K3 on the two-pendulum loop tied to the world within 1e-4;
   - collision pairs on Cassie's tree (`phase_pairs_vs_plain`): the
     slice's three leg capsule pairs (seg), a box on the pelvis against
     the L thigh (ptbox, nc 43) and a convex cloud on the R tarsus against
     the L tarsus (ptseg, nc 46), from states with the legs brought
     together (the share of envs with an active pair row printed, and at
     least 25 % asked): K3 and K2 at n_sub = 1, B = 4096, held to the
     float64 plain version by `_gate_dist_vs_f64`; with the seg pairs the
     sensor variant's physics bit-equal to K2's and K2 over 10 substeps
     bit-equal to 10 chained launches;
   - sphere sites (`phase_spheres_vs_plain`): ANYmal's feet as spheres of
     2 cm on flat ground and on a Fourier ground per env, K3 and K2 at
     n_sub = 1 env by env against float64 (`_gate_vs_f64`);
   - spherical flexibility (`phase_flex_vs_plain`, after every other
     Cassie part): K3, K2 and K2 with the sensor stage (three IMUs, two
     below the SPHERICAL joints) on the flexible-hip spec from hip
     quaternions on every branch of `jt_quat_log` (the shares printed, a
     nonzero share asked on each), held by `_gate_dist_vs_f64`, the sensor
     variant's physics bit-equal to K2's and K2 over 10 substeps to
     chained launches; with the self-collision pairs too (nc 37);
2. the paths, each with the launch counts set to 0 just before it and
   read just after:
   - the main path, ``ANYmalEnv(observe="state", device="cuda")`` reset
     from a seeded generator and 25 env steps with uniform actions: q, v,
     obs and reward finite; exactly one K2 launch per env step and no K1
     or K3 launch; then one env step from that state substep by substep,
     each substep from the same inputs: K1 equals the inline plain engine
     to 1e-4 on q and v, and K2 on q, v and λ is held to the float64
     engine env by env as in phase 1 (on these states one substep
     amplifies float32 rounding to ~1e-3 in any f32 version);
   - ``constraint_solver="kernel"`` (K1, 4 launches per env step) and an
     engine with ``substep_fusion=False`` (K3, 4 launches per env step),
     3 env steps each;
   - the sensor path, ``ANYmalEnv(observe="sensors", sensor_delay=0.004,
     imu_noise=0.02, encoder_noise=0.005)``, 25 env steps: obs (B, 33)
     and rewards finite, exactly one launch of K2 with the sensor stage per
     env step (the fused path; counted apart from the sensor-free K2's,
     which the chunked fallback would launch four times) and no other
     launch; then one env step from that state and the same eps, fused and
     chunked (4 sensor-free K2 launches at n_sub = 1 and the plain update): q and v
     bit-equal, the buffers within 1e-4 scaled as in phase 1, and each held env by env
     against the float64 plain env;
   - the terrain path (the slice: ``TERRAIN_KW``, ``anymal_sim2real_run5``
     without model randomization: a Fourier ground per env, 100 N pushes
     of 0.2 s, the sensors), 25 env steps: exactly one launch of K2 with
     the sensor stage and the ground query per env step and no other;
     then fused against chunked as for the sensor path;
   - ``terrain="perlin"`` with 6 N pushes on the state path (10 steps, one
     sensor-free ground K2 launch each), ``terrain="perlin_grid"`` (3
     steps, 12 K1 launches) and K3 on the stairs with ``substep_fusion=
     False`` (3 steps, 12 launches of K3 with the ground query);
   - the sim-to-real path (the slice: ``SIM2REAL_KW``, the terrain path
     with per-episode model randomization, ``anymal_sim2real_run5``
     whole), 25 env steps: exactly one launch of the randomized K2 with
     the sensor stage and the ground query per env step and no other;
     the auto-reset redraws exactly the finished envs' parameters; then
     fused against chunked as for the sensor path; and each other
     randomized instantiation through a path that runs it (the state,
     sensor and Perlin paths with randomization, K3 flat and on the
     stairs);
   - Cassie (``CassieEnv(sim_dt=2e-3, target_speed=0.4)``,
     ``examples/train.py --env cassie``): the state path (25 steps, one
     K2 launch each; one env step substep by substep against the inline
     engine in float32 and float64 by `_gate_dist_vs_f64`; the pushrods'
     |d − d₀| ≤ 1e-3 m in the envs 5+ steps into their episode), the
     sensor path (one launch of K2 with the sensor stage per step; fused
     bit-equal to chunked), the push path (50 N, 0.2 s), ``"kernel"``
     (K1 with the equality rows, 10 launches per step) and
     ``substep_fusion=False`` (K3, 10 per step);
   - Cassie with self-collision (the slice: ``CassieEnv(sim_dt=2e-3,
     target_speed=0.4, self_collision=True)``, nc 37, 5 colors): the state
     path (25 steps, one K2 launch each; one env step substep by substep
     against the inline engine as above; the rods within 1e-3 m), the
     sensor path (one launch of K2 with the sensor stage per step; fused
     bit-equal to chunked), the push path, ``substep_fusion=False``; the
     ptbox and ptseg pair sets on the state path; ANYmal with sphere feet
     through ``WalkerEnv`` on flat ground and on per-env Fourier ground;
   - the flexible-hip Cassie (the slice: ``CassieEnv(sim_dt=2e-3,
     target_speed=0.4, flexibility=True)``, nv 26, nq 29, nc 28), last:
     the state path (25 steps, one K2 launch each; one env step substep
     by substep against the inline engine; the rods within 1e-3 m), the
     sensor path (one launch of K2 with the sensor stage per step; fused
     bit-equal to chunked), the push path, ``substep_fusion=False``;
3. env-steps/s on the main path (3 timed loops of 25 steps), on the
   sensor path, on the terrain path, on the sim-to-real path, on the
   ``"kernel"`` path (K1) and on ``substep_fusion=False`` (K3), and
   each kernel's and its plain version's times with CUDA events beside
   the kernel's bound; the ground instantiations on each ground (the
   kernels line carries the slice's: K2 with sensors on Fourier, K2 on
   Perlin, K3 on Stairs) and the randomized instantiations, flat and on
   the Fourier ground; Cassie's three paths and its K2, K2 with the
   sensor stage (10 substeps) and K3 against their bounds (with the
   distance rows and springs counted) and plain versions; the
   self-collision paths' rates with their launches, and the pair and
   sphere-site kernels against their bounds (`_pair_flops` counted); the
   flexible paths' rates (exactly one launch per timed env step) and its
   K2, K2 with sensors and K3 against their bounds (`_JOINT`'s SPHERICAL
   terms counted).

Phases 1–3 of PRISMATIC joints and of the Ant and Spotmicro (A.15 with
B.10) run between the ANYmal parts and the Cassie parts, the slab scene
(the large frame) last:
- phase 1, `phase_prismatic_vs_plain`: K3, K2 at n_sub = 1 and over a
  step's substeps, and the randomized K3 and K2, env by env against the
  float64 plain version (`_gate_vs_f64`) on the cartpole (a third of the
  carts at a limit, the share whose bound row binds printed, a quarter
  asked) and on the slab scene with its slider along z and along the
  oblique (0.6, 0, 0.8) (the share of envs with an active pair row
  printed, a quarter asked);
- phase 2: the cartpole and the slab scene through ``Engine.step`` (one
  K2 launch per step, the carts held at their limits, the cube resting on
  the slab), and with ``substep_fusion=False`` (K3, one launch per
  substep); ``AntEnv()`` and ``SpotmicroEnv()`` on the state and sensor
  paths, 25 env steps each with exactly one K2 launch per step, the state
  path's env step substep by substep against the inline engine in
  float32 and float64 (`_gate_vs_f64`), the sensor path's fused step
  bit-equal to the chunked one;
- phase 3: the four walker paths' env-steps/s (exactly one launch per
  timed step) and the slab scene's steps/s; K2 with the sensor stage's
  first update held to float64 on each walker; the eight kernels against
  their bounds and plain versions.

Phase 0 prints, for the warp body of K2 and K3 on ANYmal and on every
large-frame model (Cassie's state and sensor paths, its self-collision,
ptbox and ptseg pairs, the flexible hips, the slab scene) and of K1 on
phase 1's systems and the ``"kernel"`` paths', the bytes per env, W and
the warps one SM holds, and every K1, K3 and K2 launch of phase 2, in
either frame, is checked to have run the warp body (`_check_warp`). The
Cassie parts of phases 1–3 run after every ANYmal number, the slab scene
last; at the end the ANYmal sensor K2 is timed again, after every
large-frame launch, beside its time before them.

Atlas (A.23) runs after the slab scene, last of the kernel parts: phase 1
`phase_atlas_vs_plain` (K3, K2 and K2 with the sensor stage without and
with the pairs, held to the float64 plain version, the bit-identities, K1
at nc 83), phases 2 and 3 `phase_atlas_paths` (the state and sensor paths
without and with the pairs through ``"auto"``, one K2 launch per env
step; with the pairs ``"kernel"``, ``substep_fusion=False`` and
``"inline"``; the rates, the pairs' path against ``"inline"``, the warp
body's stages and the six kernels against their bounds); phase 0 prints
their layouts beside the others'.

The kinematic constraints, per-body wrenches and per-env friction (A.22,
A.24) run after Atlas, `phase_chain_paths`: K1 in the gantry's (n 18, nc
31, equality blocks of 6 and 1 rows) and the wheel's (n 6, nc 3) layouts
at B = 4096 against its plain chain (and in phase 1's systems); three
scenes through the entry points a user calls, each on K1 alone as the
reference routes them: (a) ``ANYmalGantryEnv`` (the base welded 0.25 m
above its stand pose, the LF knee locked) through ``"auto"``, 4 K1
launches per env step, also counted by ``torch.profiler``; (b) ANYmal's
engine stepped with ``fext_user`` (a lateral force on each shank) and
``contact_params`` (each env's friction in [0.2, 1.2]), 4 per step, also
counted by ``torch.profiler``; (c)
wheels (``WheelConstraint``) and balls (``SphereConstraint``) on a
Fourier ground per env, 1 per substep; each scene's kernel path substep
by substep against its plain float32 and float64 paths (`_gate_vs_f64`);
the gantry's weld error after 25 steps within 1.5× the plain float32
path's (+1e-9) from one reset; rolling without slip on flat ground after
0.5 s (contact point < 1e-2 m/s, tests/test_constraints.py's bound); the
scenes' env-steps/s on ``"auto"`` and ``"inline"`` beside ANYmal's K2
state path, and K1's time against its bound in each scene's layout
(``gantry_constraint_solve``, ``fext_friction_constraint_solve``,
``rolling_constraint_solve`` in the kernels line).

The paths off the impulse engine (A.16) run after them,
`phase_penalty_paths`: (a) ANYmal on the reference's default penalty
contacts and bounds (``engine_options=EngineOptions(dt=1e-3)``: the
continuous path, plain PyTorch, no launch of ours, counted and under
``torch.profiler``), its PD stance from the stand pose standing after 1 s
(base z in [0.45, 0.6], tests/test_engine.py's bound); (b) ANYmal's
impulse engine with an impulse and a profile force on its base through
``"auto"``: 4 K1 launches per env step; (c) ``ANYmalGantryEnv`` on
penalty contacts: K1 in a layout without contact rows (nc 19), 20
launches per env step; (d) the cartpole and acrobot envs; each step
substep by substep against the plain float32 and float64 paths
(`_gate_vs_f64`), K1 at nc 19 against its plain chain and its bound
(``gantry_penalty_constraint_solve``), each path's env-steps/s and
launches per env step beside the K2 state path, ``simulate_adaptive`` on
the pendulum against the CPU's counters, and the reference's
``test_cartpole_improves`` (256 envs, 15 of its 30 iterations).

4. the policy and PPO (A.7, A.8), after every kernel number
   (`phase_training`), on ``ANYmalEnv(observe="state", max_steps=500)``
   at ``examples/train.py``'s ANYmal settings (B = 2048, rollout 32, 4
   epochs × 8 minibatches of 8,192 rows, hidden (256, 256), lr 3e-4 with
   ``anneal_lr`` over its default 4,000 iterations, ``ent_coef`` 0.005,
   the symmetry loss at 0.1):
   - the learner on the card against the CPU from the same seeded params,
     flat batch and permutations, one update and an iteration's 32:
     within 1e-5 of the params' largest |value| (`phase_learner_vs_cpu`);
   - 20 iterations of ``train_step`` with the launch counts set to 0 just
     before and read just after: exactly one K2 launch per rollout env
     step (640) and no other, the mean ``reward_mean`` of iterations
     15–19 at least 1.3 × that of iterations 0–2, every param finite; the
     curve printed;
   - env-steps/s of the rollout alone and of the whole iteration, and the
     learner's time and share of the iteration, 3 loops each;
   - the carry saved with the torch checkpoint and restored bit for bit
     (params, Adam's state, both generators), then ``evaluate`` of the
     restored greedy policy at 256 envs for 50 steps: finite, one K2
     launch per step.

5. the declarative layer (A.17, `phase_declarative`), after every other
   path: ``anymal_sensors_run5``'s recipe, ``build_pipeline(ANYmalEnv(
   observe="sensors", sensor_delay=0.004, imu_noise=0.02,
   encoder_noise=0.005, <anymal_declarative_mdp>), [mahony, stack:4])`` at
   B = 4096 (obs 148): exactly one launch of K2 with the sensor stage per
   env step over 25 and no other; the profiler's launches per env step and
   idle share beside the bare sensor env; the declarative MDP against the
   hand-coded one (identical terminations, rewards within 1e-5) and the
   declarative state path (one K2 per env step); env-steps/s of both, 3
   loops; three PPO iterations at B = 2048 through ``tools/train.py``
   (``--pipeline mahony,stack:4 --mdp declarative``), the carry's
   checkpoint bit for bit, ``freeze_pipeline_stats`` of a
   ``stack:4,normalize`` state.

6. the URDF builders (A.20) and scale-out (A.18, `phase_urdf_and_scaleout`),
   after every other part:
   - ``build_robot("data/anymal.urdf", "data/anymal_hardware.toml",
     freeflyer=True)`` → ``WalkerEnv(robot, stand_pose=stand_q, observe="state")`` at
     the main path's settings and ``data/atlas.urdf`` with its hardware
     TOML (the torso's SPHERICAL flexibility: nb 25, nv 32, nc 47, inside
     K2's caps) at AtlasEnv's: 10 env steps each at B = 4096, exactly one
     K2 launch per step; K2 on the URDF ANYmal at n_sub = 1 against its
     plain version within 1e-4;
   - the capsule-foot ANYmal (``foot_radius`` 0.02, ``foot_len`` 0.08: 8
     sphere sites, nc 36) from ``quadruped_urdf``: K2 at n_sub = 1, B =
     4096, env by env against the float64 plain version (`_gate_vs_f64`)
     from perturbed stand poses and again from the states that the stand
     run ends in; from ANYmal's bare-foot stand poses (feet 2–4 cm deep)
     by the distribution rules (`_gate_dist_vs_f64`) and the per-env
     rule's 1 % of exceptions, each exception held by an ensemble of its
     own copies with q's joints moved by ~1 float32 ulp
     (`_capsule_deep_gate`); the reference's ``test_capsule_feet_stand`` at B = 4096
     (zero actions, 25 env steps: one K2 launch per step, every base above
     0.45 m, finite, none terminated);
   - PPO on ANYmal at phase 4's settings (B = 2048) through
     ``make_distributed_train`` at world size 1 over NCCL: one train step
     from the same init bit for bit the single-device one (params, Adam's
     moments and count, metrics), 32 K2 launches each; both iterations'
     times in turns; ``dryrun_multichip(1, realistic=True)``; then two
     ranks over gloo on this card (``launch_cpu_ring``, B = 1024 per rank)
     run 4 iterations, saving a checkpoint through ``CheckpointManager``
     after the second, and print a digest of each rank's whole carry
     (params, Adam's moments and count, its env state, both generators)
     and metrics; two fresh ranks restore the checkpoint, run 2
     iterations and print theirs: the digests bit-identical rank by rank,
     the ranks' params bit-identical, 32 K2 launches per rank per
     iteration, ``restore_raw`` in this process 2 × 1024 env rows; then
     one child process restores that 2-rank checkpoint at world size 1
     over NCCL (`_restore_at_world_size_one`: the re-shard) and runs 2
     iterations, bit for bit ``PPO.train_step`` from ``restore_raw``'s
     global carry with rank 0's generators, B = 2048, 32 K2 launches per
     iteration, its seconds printed;
   - K2's time, plain time and bound on the URDF ANYmal and on the
     capsule feet (``urdf_anymal_substep_multi``,
     ``capsule_feet_substep_multi`` in the kernels line).

7. the convenience layer (A.19, A.25, `phase_convenience`), last: the
   squat of ``examples/simulate_anymal.py`` through ``Simulator.build`` /
   ``simulate`` at B = 1 (1,200 K2 launches; 25 steps from the logged
   states against float64; the log and the robot rebuilt from it bit for
   bit), ``simulate_batch`` at B = 4096 (50 K2 launches, bit for bit a loop
   of ``Engine.step``, its rate beside the K2 state path's),
   ``Engine.set_options`` on live envs (the sensor env unfused: K3 × 4;
   fused again: one sensor K2; ``pgs_iters`` 16 as a fresh engine),
   ``Engine.simulate``, ``play``, a rendered frame, ``state_flags``, PCG32
   and ``parity.compare`` on the card; its launches join the K2, K3 and
   sensor-K2 rows of the kernels line.

Every phase prints its seconds on a ``[seconds]`` line, and the run its
total beside the host's K2 state path rate. The line before the last is
a JSON object with the kernels' numbers; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # non-tensor-core float32

TOL = 1e-4  # f32 reassociation between the kernel and the plain version
B_MAIN = 4096
STEPS = 25


_CLOCK = {"start": 0.0, "last": 0.0}


def _lap(label: str) -> float:
    """Print the seconds since the previous lap (or the run's start) on a
    line of their own, with the run's total so far; returns them."""
    now = time.perf_counter()
    took, _CLOCK["last"] = now - _CLOCK["last"], now
    print(f"[seconds] {label}: {took:.1f} s (the run so far {now - _CLOCK['start']:.1f} s)",
          flush=True)
    return took


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _rand_system(gen, B, n, nc, dev, active_p=0.7):
    """Random well-conditioned systems, made as tests/test_pallas_solve.py
    makes them."""
    kw = dict(generator=gen, device=dev)
    R = torch.randn(B, n, n, **kw) * 0.3
    M = R @ R.transpose(1, 2) + 2.0 * torch.eye(n, device=dev)
    p = torch.randn(B, n, **kw)
    v = torch.randn(B, n, **kw) * 0.5
    J = torch.randn(B, nc, n, **kw) * 0.5
    target = torch.randn(B, nc, **kw) * 0.1
    mu = torch.full((B, nc), 0.8, device=dev)
    active = (torch.rand(B, nc, **kw) < active_p).float()
    lam0 = torch.randn(B, nc, **kw) * 0.01
    return M, p, v, J, target, mu, active, lam0


def _solve_flops(cfg) -> int:
    """Floating-point operations that one env's chain needs (a
    multiply-add is 2), counted from the algorithm on dense M and J, the
    Delassus matrix J·M⁻¹·Jᵀ as its symmetric half; no part of it depends
    on the data."""
    n, nc, m = cfg.n, cfg.nc, cfg.nc + 1
    chol = sum(2 * (n - j) * j + (n - j) for j in range(n))
    solves = 2 * (2 * (n * (n - 1) // 2) * m + n * m)
    delassus = nc * (nc + 1) * n + 2 * nc * n + 2 * n
    pgs = cfg.iters * nc * (2 * nc + 4)
    vnext = 2 * n * nc
    resid = 2 * nc * nc if cfg.compute_residual else 0
    return chol + solves + delassus + pgs + vnext + resid


def _solve_bytes(cfg, B) -> int:
    """Bytes in (M, p, v, J, target, mu, active, λ0) and out (v⁺, λ,
    residual), each read or written once, float32."""
    n, nc = cfg.n, cfg.nc
    return 4 * B * (n * n + 2 * n + nc * n + 4 * nc + n + nc + 1)


def _time_cuda(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _chain_configs() -> dict:
    """Phase 1's systems for K1: ANYmal's, Atlas's and Cassie's layouts,
    the gantry ANYmal's (a weld's 6 rows and a lock's 1 ahead of ANYmal's
    rows) and the rolling wheel's (its 3 rows alone)."""
    from jiminy_tpu_torch.engine.solver import BlockSpec
    from jiminy_tpu_torch.ops.constraint_solve import SolveConfig

    return {
        "anymal": SolveConfig(
            n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
            contact_colors=((12, 2), (18, 2)), iters=4,
        ),
        "atlas": SolveConfig(
            n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
            contact_colors=((23, 4), (35, 4)), iters=4,
        ),
        "cassie": SolveConfig(
            n=22, nc=26, dt=2e-3, eq_blocks=(BlockSpec("equality", 0, 4),),
            bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)),
            iters=4, relax=0.9,
        ),
        "gantry": SolveConfig(
            n=18, nc=31, dt=5e-3,
            eq_blocks=(BlockSpec("equality", 0, 6), BlockSpec("equality", 6, 1)),
            bounds_span=(7, 12), contact_colors=((19, 2), (25, 2)), iters=4,
        ),
        "wheel": SolveConfig(
            n=6, nc=3, dt=1e-3, eq_blocks=(BlockSpec("equality", 0, 3),), bounds_span=None,
            contact_colors=(), iters=4,
        ),
    }


def phase_kernel_vs_plain(dev) -> float:
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference

    base = _chain_configs()
    cases = []
    for name, cfg in base.items():
        for resid in (True, False):
            cases.append((f"{name} residual={resid}", dataclasses.replace(cfg, compute_residual=resid), 64))
    main_cfg = dataclasses.replace(base["anymal"], iters=8)
    cases += [
        ("anymal B=4096 iters=8", main_cfg, B_MAIN),
        ("anymal B=4096 iters=8 residual", dataclasses.replace(main_cfg, compute_residual=True), B_MAIN),
        ("anymal ragged B=1000 iters=8", dataclasses.replace(main_cfg, compute_residual=True), 1000),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for label, cfg, B in cases:
        args = _rand_system(gen, B, cfg.n, cfg.nc, dev)
        vk, lk, rk = solve_batched(cfg, *args, device=dev)
        vr, lr, rr = solve_reference(cfg, *args)
        torch.cuda.synchronize()
        errs = [
            (vk - vr).abs().max().item(),
            (lk - lr).abs().max().item(),
            (rk - rr).abs().max().item() if cfg.compute_residual else 0.0,
        ]
        print(f"[phase 1] {label}: max|dv|={errs[0]:.3g} max|dlam|={errs[1]:.3g} "
              f"max|dres|={errs[2]:.3g}")
        if not all(e <= TOL for e in errs):
            raise AssertionError(f"kernel disagrees with the plain version on {label}: {errs}")
        if "B=4096" in label and not cfg.compute_residual:
            worst = max(worst, errs[0], errs[1])
            again = solve_batched(cfg, *args, device=dev)
            same = all(torch.equal(a, b) for a, b in zip(again, (vk, lk, rk)))
            print(f"[phase 1] {label}: a second launch bit-equal: {same}")
            if not same:
                raise AssertionError(f"K1 is not deterministic on {label}")
    return worst


# Operations of the small helpers of csrc/substep.cu on general operands,
# counted from their code (a multiply-add is 2; a sqrt, sin, cos, tanh or
# division 1).
_OPS = {"cross": 9, "dot": 5, "mat3_mul": 45, "mat3_vec": 15, "quat_to_m": 30,
        "p2c": 42, "c2p": 42, "imul": 42, "mcross_f": 30}


# Per joint type (0 FREE, 1 REVOLUTE, 2 PRISMATIC, 3 SPHERICAL: the codes
# of core/tree.py JointType), the operations of its branches in
# csrc/substep.cuh, without those the kernel's generic loops spend on
# known zeros, ones and duplicates. A FREE or SPHERICAL joint's motion
# subspace is unit columns (projecting onto it or multiplying by it
# selects entries: 0 operations), a REVOLUTE joint's (axis, 0) and a
# PRISMATIC one's (0, axis) (3 products):
# - rot: the joint's rotation (a quaternion to a matrix; Rodrigues: sin,
#   cos, 1 − cos and I + sin·K + (1 − cos)·K² with its constant K², 27;
#   a PRISMATIC joint's rotation is the identity);
# - pose: the local pose from the placement (R_p·R_j; R_p·p_j + p_p, the
#   product skipped where p_j is 0, 3 more for the axis·q of PRISMATIC);
# - sq: the nonzeros of S·q̇ (summed into the body's velocity);
# - vcross: v × S·q̇ on S·q̇'s nonzeros (RNEA, and the sensor stage);
# - proj: Sᵀ·f (a dot with the axis for the 1-DoF joints);
# - f_is: F = I_c·S and its diagonal block SᵀF (I·axis, h × axis and a
#   dot for REVOLUTE; h × axis, m·axis and a dot for PRISMATIC);
# - col: one point-Jacobian column R·S_c (× r for an angular one);
# - integ: the configuration step (FREE: R·v_lin·dt and the quaternion's
#   exp, product and normalization, 109; SPHERICAL the quaternion's
#   alone, 58; a scalar joint 2);
# - spring: −k·log(quat) of a sprung SPHERICAL joint (`jt_quat_log`: |xyz|²
#   5, the sqrt 2, atan2, ×2 and ÷ 3, the scaled vector 3; k·rv and τ −
#   6), −k·q of a sprung 1-DoF joint (2).
_JOINT = {
    0: dict(ndof=6, rot=30, pose=15 + 3 + 45, sq=6, vcross=30, proj=0, f_is=0, col=(3, 9),
            integ=109, spring=0),
    1: dict(ndof=1, rot=27, pose=45 + 3, sq=3, vcross=18, proj=5, f_is=15 + 9 + 5,
            col=(1, 24), integ=2, spring=2),
    2: dict(ndof=1, rot=0, pose=3 + 15 + 3, sq=3, vcross=9, proj=5, f_is=9 + 3 + 5,
            col=(1, 15), integ=2, spring=2),
    3: dict(ndof=3, rot=30, pose=45 + 3, sq=3, vcross=18, proj=0, f_is=0, col=(3, 9),
            integ=58, spring=19),
}


def _col_flops(jt, per_col) -> int:
    """A Jacobian's columns on a joint of type ``jt`` (r = p − o, 3, then
    each column as `_JOINT`'s col counts it), each followed by ``per_col``
    operations of the caller (0 for the contact rows, which store
    [−J_y; J_x; J_z]); FREE: three unit linear columns (0) and three
    angular ones (× r, 9 each)."""
    k = _JOINT[jt]
    n_cols, ops = k["col"]
    return 3 + n_cols * ops + k["ndof"] * per_col


def _substep_flops(spec) -> int:
    """Operations that one env's substep needs, walked over this tree in
    the order of csrc/substep_warp.cuh `jt_warp_substep`, with each joint's branches
    as `_JOINT` counts them: gravity has no angular part, and the composite
    inertias and the Delassus matrix are symmetric (one half counted). The
    chain is counted on dense M and J, as K1 takes them (`_solve_flops`).
    No branch depends on the data except sign and clamp selections, which
    cost the same either way."""
    t, O = spec.tree, _OPS
    fk = rnea = crba = jac = integ = 0
    for i in range(t.nb):
        k, root = _JOINT[int(t.joint_type[i])], t.parent[i] < 0
        # FK: joint rotation, local pose, S·q̇
        fk += k["rot"] + k["pose"]
        if not root:  # world pose; velocity = parent's in this frame + S·q̇
            fk += O["mat3_mul"] + O["mat3_vec"] + 3 + O["p2c"] + k["sq"]
        # RNEA: acceleration (gravity at the root: Rᵀ·g), v × S·q̇ (S·q̇
        # from FK), I·a + v ×* (I·v), Sᵀ·f, force to the parent
        if root:
            rnea += O["mat3_vec"]
        else:
            rnea += O["p2c"] + k["vcross"] + 6
        rnea += 2 * O["imul"] + O["mcross_f"] + 6 + k["proj"]
        if not root:
            rnea += O["c2p"] + 6
            # composite inertia to the parent: R·h, h + m·p, R·I·Rᵀ (its
            # 6 unique entries), the two parallel-axis terms, the sums
            crba += O["mat3_vec"] + 6 + O["mat3_mul"] + 6 * 5 + 2 * O["dot"] + 4 + 48
        # F = Ic·S, its diagonal block Sᵀ·F, then F carried up the
        # ancestors and projected on each one's subspace
        crba += k["f_is"]
        j = i
        while t.parent[j] >= 0:
            crba += k["ndof"] * O["c2p"]
            j = t.parent[j]
            crba += k["ndof"] * _JOINT[int(t.joint_type[j])]["proj"]
        integ += k["integ"]
    rnea += 6  # the root wrench
    crba += 2 * t.nv  # armature + dt·damping (a constant), p = τ − bias
    for b in t.contact_body:
        jac += O["mat3_vec"] + 3 + 7  # point, depth, target, activation
        for jt in _chain_types(t, b):
            jac += _col_flops(jt, 0)
    rows = 6 * len(spec.bounded_joints)
    return fk + rnea + crba + jac + rows + _distance_flops(spec) + _spring_flops(spec) \
        + _pair_flops(spec) + _solve_flops(spec.cfg) + integ


def _distance_flops(spec) -> int:
    """Operations of the distance rows (`jt_distance_row`), per constraint:
    each point on a body R·p + x (18), p₁ − p₂ (3), d = √(|·|² + 1e-24)
    (7), u (4), then per Jacobian column of each point's chain the column
    (`_col_flops`), its dot with u, the sign and the sum (7), and the
    target −(α/dt)·(d − d₀) (3). A point of the world costs nothing."""
    t = spec.tree
    n = 0
    for b1, _, b2, _, _, _ in spec.dist_constraints:
        n += 3 + 7 + 4 + 3
        for b in (b1, b2):
            n += 18 if b >= 0 else 0
            n += sum(_col_flops(jt, 7) for jt in _chain_types(t, b))
    return n


def _chain_types(t, b) -> list:
    """The joint types on body b's chain to the root."""
    types, j = [], b
    while j >= 0:
        types.append(int(t.joint_type[j]))
        j = t.parent[j]
    return types


def _pair_contact_flops(t, ba, bb) -> int:
    """Operations of one `jt_pair_contact`: the basis (n × ref 9, its
    normalization 9, t2 = n × t1 9), per Jacobian column of each point's
    chain the column (`_col_flops`) and its three dots with the basis,
    each signed and summed (3 · 7), and the target and activation (7)."""
    return 27 + 7 + sum(_col_flops(jt, 21) for b in (ba, bb) for jt in _chain_types(t, b))


def _pair_flops(spec) -> int:
    """Operations of the pairs' narrow phases and rows (`jt_pair_item`)
    and of the sphere sites' offset. seg: the four world endpoints (4 ·
    18), `jt_seg_seg` (the differences 9, five dots 25, the clamped s and t
    16, the re-clamped s 6, the closest points 12), the normal and depth
    (d 3, its norm 7, n 3, depth 2) and the surface points (12); ptbox: the
    box's world centre and axes (18 + 45), per point its world position
    (18), the box frame (3 + 15), `jt_box_sdf` (40), the normal to the
    world (15), depth and surface points (13); ptseg: the capsule's world
    ends and axis (36 + 3 + 5), per point its world position (18), the
    clamped projection (3 + 5 + 2 + 6), the normal and depth (3 + 7 + 3 +
    2) and surface points (12). Each contact then `_pair_contact_flops`. A
    sphere site adds its offset (1 on flat ground; a second ground query
    and 9 on an analytic one)."""
    t, n = spec.tree, 0
    for kind, g in (spec.pairs.gens if spec.pairs is not None else ()):
        if kind == "seg":
            n += 4 * 18 + 9 + 25 + 16 + 6 + 12 + 15 + 12 + _pair_contact_flops(t, g["ba"], g["bb"])
            continue
        k = len(g["pts"])
        n += 18 + 45 if kind == "ptbox" else 36 + 3 + 5
        per = 18 + 18 + 40 + 15 + 13 if kind == "ptbox" else 18 + 16 + 15 + 12
        n += k * (per + _pair_contact_flops(t, g["bp"], g["bf"]))
    sites = sum(r > 0 for r in spec.contact_radius)
    return n + sites * (1 if spec.ground_mode == "flat" else _ground_query_flops(spec) + 9)


def _spring_flops(spec) -> int:
    """The implicit springs' terms in the substep when the tree has any:
    per dof dt·damping + dt²·k on M's diagonal (3 more than damping alone)
    and τ − dt·k·v (3)."""
    return 6 * spec.tree.nv if spec.springs else 0


def _torque_flops(spec) -> int:
    """Operations of `jt_torque`: ~23 per motor, damping 2 per dof, the
    springs (−k·q 2 per sprung 1-DoF joint, −k·log(quat) 19 per sprung
    SPHERICAL joint; `_JOINT`)."""
    t = spec.tree
    return (23 * spec.torque.nm + 2 * t.nv + _JOINT[1]["spring"] * len(t.sprung_joints[0])
            + _JOINT[3]["spring"] * len(t.sprung_spherical[0]))


def _spec_bytes(spec) -> int:
    si, sf = spec.packed("cpu")
    return 4 * (si.numel() + sf.numel())


def _substep_bytes(spec, B) -> int:
    """K3: q, v, τ, λ0, wrench in; q, v, λ, residual, impulses out
    (float32), and the packed spec once."""
    t = spec.tree
    per_env = (t.nq + 2 * t.nv + spec.nc + 6) + (t.nq + t.nv + spec.nc + 1 + 3 * t.ncp)
    return 4 * B * per_env + _spec_bytes(spec)


def _substep_multi_bytes(spec, B) -> int:
    """K2: q, v, cmd, λ0, wrench in; q, v, λ, residual, impulses, a, τ
    out (float32), and the packed spec once."""
    t, nm = spec.tree, spec.torque.nm
    per_env = (t.nq + t.nv + nm + spec.nc + 6) + (t.nq + 3 * t.nv + spec.nc + 1 + 3 * t.ncp)
    return 4 * B * per_env + _spec_bytes(spec)


def _sensor_flops(spec, sens) -> int:
    """Operations that one sensor update of one env needs (what
    `jt_sensor_stage` does): the world rotations of the bodies on the
    chains to the IMU and contact bodies (the joint rotation as
    `_JOINT` counts it, the placement product and, below the root,
    the world product); on the chains to the IMU bodies alone the local
    position, velocity and proper acceleration: a = Δv/dt on the joint's
    dofs (2 each), S·v and S·a (3 products each on a 1-DoF axis), at the
    root Rᵀ·(−g) (gravity has no angular part) and the sums with S·a's
    nonzeros, below it the velocity (p2c, the sums with S·v's) and the
    acceleration (p2c, v × S·v, the sums with S·a's and with the cross
    term); then per IMU the frame
    rotation (45), the quaternion from it (30), the proper acceleration
    (4 cross products and 9 sums), gyro and accelerometer (2 × 15), the
    turn by exp(rv) (45) and 6 eps sums; per encoder 2, effort 1, contact
    3 divisions, a transposed product and 3 sums (21). Pushing the ring
    buffers moves data and does no arithmetic."""
    t, O = spec.tree, _OPS
    need = sens.packed("cpu")[0][:t.nb].tolist()  # 0, rotation 1, motion 3
    n = 0
    for i in range(t.nb):
        if not need[i]:
            continue
        k, root = _JOINT[int(t.joint_type[i])], t.parent[i] < 0
        n += k["rot"] + O["mat3_mul"]
        if not root:
            n += O["mat3_mul"]
        if need[i] != 3:
            continue
        # a = Δv/dt; S·v and S·a (3 products each on a 1-DoF joint's axis)
        n += 2 * k["ndof"] + (6 if k["proj"] else 0)
        n += O["mat3_vec"] + 3 if t.joint_type[i] == 0 else 0  # local position
        sa = k["sq"]  # S·v's or S·a's nonzeros, summed
        if root:
            n += O["mat3_vec"] + sa
        else:
            n += O["p2c"] + sa + O["p2c"] + k["vcross"] + sa + 6
    per = {"imu": 45 + 30 + 4 * O["cross"] + 9 + 2 * O["mat3_vec"] + 45 + 6,
           "encoder": 2, "effort": 1, "contact": 3 + O["mat3_vec"] + 3}
    return n + sum(per[g.type] * g.ns for g in sens.suite.groups)


def _sensor_bytes(sens, B, n_upd) -> int:
    """The sensor stage's own traffic: the buffers in and out and the eps
    (float32), and the packed suite once."""
    gi, gf = sens.packed("cpu")
    return 4 * B * (2 * sens.n_buf + n_upd * sens.n_eps) + 4 * (gi.numel() + gf.numel())


GROUND_KINDS = ("fourier", "perlin", "stairs")


def _ground_template(kind, dev):
    """The engine's ground of each analytic kind at ANYmalEnv's settings:
    a 16-term Fourier ground and a 3-octave Perlin ground (amplitude 0.08,
    wavelength 1.5), the staircase 0.4 × 0.08 m, 10 steps, 5 cm ramps."""
    from jiminy_tpu_torch.engine import ground as pg

    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "fourier":
        return pg.sample_fourier_ground(gen, n_terms=16, amplitude=0.08, wavelength=1.5, octaves=3)
    if kind == "perlin":
        return pg.sample_perlin_ground(gen, amplitude=0.08, wavelength=1.5, octaves=3)
    return pg.StairsGround.create(0.4, 0.08, 10, 0.05, device=dev)


def _ground_inputs(eng, kind, gen, B):
    """``_substep_inputs`` spread over the terrain: bases uniform over
    ±2 m (stairs: x over [−0.5, 4.5] m, the whole flight, y ±1 m), raised
    by the mean height under the feet; a fresh ground per env (stairs:
    x0 ~ U(−0.2, 0.2)) as its coefficients (B, n_gc); and the number of
    contacts whose ground normal takes the steep switch (n_z < 0.9)."""
    from jiminy_tpu_torch.core import algos
    from jiminy_tpu_torch.engine import ground as pg
    from jiminy_tpu_torch.engine.contact import contact_points_world

    q, v, cmd, lam0, wrench = _substep_inputs(eng, gen, B)
    kw = dict(generator=gen, device=q.device)
    if kind == "fourier":
        gc = pg.sample_fourier_ground(gen, 16, 0.08, 1.5, 3, batch_shape=(B,)).coef()
    elif kind == "perlin":
        gc = pg.sample_perlin_ground(gen, 0.08, 1.5, 3, batch_shape=(B,)).coef()
    else:
        gc = eng.ground.coef().expand(B, -1).clone()
        gc[:, 4] = 0.4 * torch.rand(B, **kw) - 0.2
    if kind == "stairs":
        q[:, 0] = 5.0 * torch.rand(B, **kw) - 0.5
        q[:, 1] = 2.0 * torch.rand(B, **kw) - 1.0
    else:
        q[:, 0:2] = 4.0 * torch.rand(B, 2, **kw) - 2.0
    ground = type(eng.ground).from_coef(gc, eng.ground)

    def feet_xy():
        xw, vel = algos.kinematics(eng.tree, q, v)
        return contact_points_world(eng.tree, xw, vel)[0][..., :2]

    q[:, 2] += ground.query(feet_xy())[0].mean(1)
    steep = int((ground.query(feet_xy())[1][..., 2] < 0.9).sum())
    return (q, v, cmd, lam0, wrench), gc.contiguous(), steep


def _ground_query_flops(spec) -> int:
    """Operations of one `jt_ground_query` on this spec's ground, counted
    from its code (an add, multiply, compare, select, floor, conversion or
    integer multiply, xor or shift 1, a multiply-add 2, sinf and cosf 1
    each, a division 1): Fourier 14 per term (the argument 4, sin and cos
    2, the height 2, each gradient component 3); Perlin 148 per octave
    (frequency and weight 2, scaled point 2, floors, fractions and
    conversions 6, four corners of 18 each: the two lattice sums and 9
    for the hash, 2 sign selects, the corner's dot product 5; the two
    fades and their derivatives 22, the height's blend 9, the x
    gradient's 15, the y gradient's 12, the accumulation 8) and 16 for
    the fBm scale; Stairs 21."""
    if spec.ground_mode == "fourier":
        return 14 * spec.ground_n
    if spec.ground_mode == "perlin":
        return 148 * spec.ground_n + 16
    return 21 if spec.ground_mode == "stairs" else 0


def _ground_flops(spec) -> int:
    """What the analytic ground adds to one env's substep beyond
    `_substep_flops` (flat ground): per contact the query, the contact
    frame (`jt_contact_basis`: the normal 8, the steep switch 3, t1 = ref ×
    n̂ 9 and its normalization 10, t2 = n̂ × t1 9: 39), the three rows
    [t1; t2; n̂]·J_p (15 per Jacobian column, where flat ground permutes
    the column for free) and the world impulse t1·λ₀ + t2·λ₁ + n̂·λ₂ (15)."""
    t = spec.tree
    n = 0
    for b in t.contact_body:
        cols = sum(_JOINT[jt]["ndof"] for jt in _chain_types(t, b))
        n += _ground_query_flops(spec) + 39 + 15 * cols + 15
    return n


def _anymal_suite(dev, dtype=torch.float32, period=5e-3, delay=0.004):
    """ANYmal's sensor suite at the flagship's settings (anymal_sensors_run5:
    delay 0.004 s, IMU noise 0.02, encoder noise 0.005)."""
    from jiminy_tpu_torch.models.quadruped import make_anymal

    _, _, suite = make_anymal(device=dev, sensor_period=period, sensor_delay=delay,
                              imu_noise=0.02, encoder_noise=0.005)
    return suite.to(dtype=dtype)


def _anymal_engine(dev, dtype=torch.float32, residual=True, fusion=True, solver="substep",
                   ground=None):
    """The flagship env's engine (PD kp 80, kd 2, 5 ms, 8 sweeps), on flat
    ground or ``ground``. In float64 the model holds the float32 model's
    constants, so the two differ by the arithmetic alone."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.quadruped import make_anymal

    tree, motors, _ = make_anymal(device=dev)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         compute_solver_residual=residual,
                         substep_fusion=fusion, constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(80.0, 2.0), ground=ground, device=dev)


def _substep_inputs(engine, gen, B, stand=None):
    """ANYmal states around the stand pose (``stand``: another stand pose
    of the tree, e.g. with capsule feet): joints ±0.15 rad, in a
    quarter of the envs the four HAA joints within 1 cm·rad of a position
    limit (either side of it, so that the bounds rows bind), base 2 cm
    low to 1 cm high (feet penetrating, hovering within the contact margin
    and clear of it) and tilted, v ~ 0.3·N(0, 1), λ0 ≥ 0, PD targets ±0.2
    rad around the joints, a root wrench of ~5 N·m and ~20 N."""
    from jiminy_tpu_torch.models.quadruped import stand_q

    dev, t = engine.device, engine.tree
    kw = dict(generator=gen, device=dev)
    qi = list(engine.motors.q_idx)
    q = torch.as_tensor(stand_q(t) if stand is None else stand, device=dev).repeat(B, 1)
    q[:, qi] += 0.3 * torch.rand(B, len(qi), **kw) - 0.15
    haa = [t.q_off[t.joint_index(n)] for n in t.joint_name if n.endswith("_HAA")]
    hi = t.q_max[haa].to(dev)
    side = torch.where(torch.rand(B // 4, len(haa), **kw) < 0.5, -1.0, 1.0)
    q[:B // 4, haa] = side * (hi + 0.02 * torch.rand(B // 4, len(haa), **kw) - 0.01)
    q[:, 2] += 0.03 * torch.rand(B, **kw) - 0.02
    quat = torch.cat([0.1 * torch.rand(B, 3, **kw) - 0.05, torch.ones(B, 1, device=dev)], 1)
    q[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    v = 0.3 * torch.randn(B, engine.tree.nv, **kw)
    lam0 = (0.05 * torch.randn(B, engine.nc, **kw)).abs()
    cmd = q[:, qi] + 0.4 * torch.rand(B, len(qi), **kw) - 0.2
    wrench = torch.cat([5.0 * torch.randn(B, 3, **kw), 20.0 * torch.randn(B, 3, **kw)], 1)
    return q, v, cmd, lam0, wrench


WARP_SOURCE = "jiminy_tpu_torch/csrc/substep_warp.cuh"  # K3 and K2, every model


def _warp_report(dev):
    """Phase 0 for the warp kernels: per instantiation of K2 (SENS, GEN,
    RAND), K3 (GEN, RAND) and K1 ptxas's registers, stack and spills; the
    bytes per env, W and the warps one SM holds (registers and shared
    memory counted) of K2 and K3 on ANYmal (flat and on the Fourier ground,
    K2 with and without the sensor stage) and on every large-frame model,
    and of K1 on phase 1's systems and on each ``"kernel"`` path's (Atlas
    with and without its pairs among them)."""
    from jiminy_tpu_torch.ops import _build
    from jiminy_tpu_torch.ops import constraint_solve as cs
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec, warp_blocks_per_sm

    kernels = ((r"substep_multi_warp_kernelILb(\d)ELb(\d)ELb(\d)E", "K2 warp body <SENS {} GEN {} "
                "RAND {}>"), (r"substep_warp_kernelILb(\d)ELb(\d)E", "K3 warp body <GEN {} RAND {}>"),
               (r"solve_chain_warp_kernel()", "K1 warp body{}"))
    for lib in ("substep", "substep_rand", "constraint_solve"):
        name, frame = None, ""
        for line in _build.ptxas_report(lib):
            if "Compiling entry" in line:
                name = None
                for pattern, fmt in kernels:
                    m = re.search(pattern, line)
                    if m is not None:
                        name = fmt.format(*m.groups())
                        break
            elif name and "stack frame" in line:
                frame = line
            elif name and "Used" in line:
                print(f"[phase 0] {name} ({lib}): {line}; {frame}")
                name = None

    def report(label, spec, sens=None, ground=False):
        ws = spec.warp_workspace(sens)
        k2 = {rand: ws.W * warp_blocks_per_sm(ws, sens is not None, ground, rand)
              for rand in (False, True)}
        line = (f"[phase 0] K2 warp body on {label} (nb {spec.tree.nb}, nv {spec.tree.nv}, nc "
                f"{spec.nc}): {ws.bytes_per_env} B per env, W = {ws.W} envs per block "
                f"({ws.W * ws.bytes_per_env} B), warps per SM (nominal, randomized) {k2[False]}, "
                f"{k2[True]}")
        if sens is None:  # K3 takes K2's layout without the sensor stage
            k3 = {rand: ws.W * warp_blocks_per_sm(ws, False, ground, rand, multi=False)
                  for rand in (False, True)}
            line += f"; K3 in the same layout: warps per SM {k3[False]}, {k3[True]}"
        print(line)

    sens = SensorKernelSpec(_anymal_engine(dev).tree, _anymal_suite(dev), 1)
    for kind in ("flat", "fourier"):
        spec = _anymal_engine(dev, ground=_ground_template(kind, dev)
                              if kind != "flat" else None).substep_spec
        for with_sens in (False, True):
            report(f"ANYmal, {kind} ground, sensor stage {with_sens}", spec,
                   sens if with_sens else None, kind != "flat")
    # the large frame: Cassie's paths, its pair sets and flexible hips, the slab
    pairs = _pair_sets()
    tree, _, suite, _, _ = _cassie_model(dev)
    ftree, _, fsuite, _, _ = _cassie_model(dev, flexibility=True)
    large = (
        ("cassie state", _cassie_engine(dev), None),
        ("cassie sensors", _cassie_engine(dev), SensorKernelSpec(tree, suite, 1)),
        ("cassie self-collision", _cassie_engine(dev, pairs=pairs["seg"]), None),
        ("cassie ptbox", _cassie_engine(dev, pairs=pairs["ptbox"]), None),
        ("cassie ptseg", _cassie_engine(dev, pairs=pairs["ptseg"]), None),
        ("cassie flex", _cassie_engine(dev, flexibility=True), None),
        ("cassie flex sensors", _cassie_engine(dev, flexibility=True),
         SensorKernelSpec(ftree, fsuite, 1)),
        ("prismatic slab", _slab_engine(dev), None),
    )
    atlas_sens = SensorKernelSpec(_atlas_model(dev)[0], _atlas_model(dev)[2], 1)
    large += (
        ("atlas state", _atlas_engine(dev), None),
        ("atlas sensors", _atlas_engine(dev), atlas_sens),
        ("atlas self-collision", _atlas_engine(dev, pairs=True), None),
        ("atlas self-collision sensors", _atlas_engine(dev, pairs=True), atlas_sens),
    )
    for name, eng, s in large:
        report(name, eng.substep_spec, s)
    # K1: phase 1's systems, and the "kernel" paths' (ANYmal, its heightmap, Cassie)
    for name, cfg in list(_chain_configs().items()) + [
            ("anymal 'kernel' path", _anymal_engine(dev).substep_spec.cfg),
            ("cassie 'kernel' path", _cassie_engine(dev).substep_spec.cfg),
            ("atlas 'kernel' path", _atlas_engine(dev).substep_spec.cfg),
            ("atlas self-collision 'kernel' path",
             _atlas_engine(dev, pairs=True).substep_spec.cfg)]:
        ws = cs.warp_workspace(cfg)
        print(f"[phase 0] K1 warp body on {name} (n {cfg.n}, nc {cfg.nc}): {ws.bytes_per_env} B "
              f"per env, W = {ws.W} envs per block ({ws.W * ws.bytes_per_env} B), warps per SM "
              f"{ws.W * cs.warp_blocks_per_sm(ws)}")


def _max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def _env_err(a, b):
    """max |a − b| of each env, (B,) float64."""
    return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(dim=1)


# Two float32 versions of the same physics round differently, and where
# a state sits near a switch of the PGS active set (a contact on the
# verge of sliding, a row about to release), one substep amplifies that
# rounding to ~1e-3 in v, in any float32 version (PERF.md, Findings). So
# K2 is held, env by env, against the plain version in float64 and beside
# the plain version's own float32 distance to it:
# - per env: |K2 − f64| ≤ 2·|plain f32 − f64| + 1e-4, in all but 1 % of
#   the envs (an env where K2's rounding tips the active set and the
#   plain version's does not); a fault of one mechanism (the bounds rows,
#   the carried λ, a contact row) shows in every env that uses it;
# - envs farther than 1e-4 from f64: K2's count ≤ 1.5 × the plain
#   version's + 4 (counting noise where both are small);
# - the worst env: K2's ≤ 2 × the plain version's + 1e-4.
ENV_EXCEPTIONS = 0.01


def _gate_vs_f64(label, k, p32, p64) -> dict:
    """K2's output ``k`` against the plain version in float32 and float64
    on the same inputs, by the three rules above; raises when one fails."""
    dk, dp = _env_err(k, p64), _env_err(p32, p64)
    g = {
        "kernel_vs_f64": dk.max().item(),
        "plain_f32_vs_f64": dp.max().item(),
        "kernel_vs_plain_f32": _env_err(k, p32).max().item(),
        "envs_kernel_over_1e-4": int((dk > TOL).sum()),
        "envs_plain_over_1e-4": int((dp > TOL).sum()),
        "envs_kernel_worse": int((dk > 2.0 * dp + TOL).sum()),
    }
    if g["envs_kernel_worse"] > ENV_EXCEPTIONS * k.shape[0]:
        raise AssertionError(f"{label}: K2 is further from f64 than 2 × the plain f32 "
                             f"version + 1e-4 in more than 1 % of the envs: {g}")
    if g["envs_kernel_over_1e-4"] > 1.5 * g["envs_plain_over_1e-4"] + 4:
        raise AssertionError(f"{label}: K2 is off f64 by more than 1e-4 in more envs "
                             f"than 1.5 × the plain f32 version + 4: {g}")
    if g["kernel_vs_f64"] > 2.0 * g["plain_f32_vs_f64"] + TOL:
        raise AssertionError(f"{label}: K2's worst env is further from f64 than 2 × the "
                             f"plain f32 version's + 1e-4: {g}")
    return g


def _k3_equals_k2(label, spec, args, **kw):
    """K3 given K2's applied τ against K2 at n_sub = 1 from ``args`` (q, v,
    cmd, λ0, wrench) and ``kw`` (gc, mp): one substep body, so q, v, λ, the
    residual and the impulses bit-equal; raises when one is not."""
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched, substep_batched_multi

    q, v, _, lam0, wrench = args
    k2 = substep_batched_multi(spec, 1, *args, **kw)
    k3 = substep_batched(spec, q, v, k2[6], lam0, wrench, **kw)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("q", "v", "lam", "residual", "impulse"), k3, k2)
              if not torch.equal(a, b)]
    print(f"[phase 1] {label}: K3 given K2's applied τ bit-equal to K2 at n_sub=1 on q, v, λ, the "
          f"residual and the impulses: {not differ}")
    if differ:
        raise AssertionError(f"{label}: K3 given K2's τ differs from K2 at n_sub=1 in {differ}")


def phase_substep_vs_plain(dev) -> dict:
    """K3 and K2 against their plain versions; returns each kernel's
    worst error at B = 4096 (K2 at n_sub = 1)."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    eng = _anymal_engine(dev)
    spec, dt = eng.substep_spec, eng.substep_spec.dt
    gen = torch.Generator(device=dev).manual_seed(3)
    names = ("q", "v", "lam", "residual", "impulse")
    worst = {"substep": 0.0, "substep_multi": 0.0}
    for label, B in ((f"B={B_MAIN}", B_MAIN), ("ragged B=1000", 1000)):
        q, v, cmd, lam0, wrench = _substep_inputs(eng, gen, B)
        tau = eng._joint_torque(cmd, q, v)
        k3 = substep_batched(spec, q, v, tau, lam0, wrench)
        r3 = substep_reference(spec, q, v, tau, lam0, wrench)
        k2 = substep_batched_multi(spec, 1, q, v, cmd, lam0, wrench)
        r2 = substep_multi_reference(spec, 1, q, v, cmd, lam0, wrench)
        torch.cuda.synchronize()
        e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
        e2 = {n: _max_err(a, b) for n, a, b in zip(names + ("a", "tau"), k2, r2)}
        active = float((r3[2] != 0).double().mean())
        bound = float((r3[2][:, :len(spec.bounded_joints)] != 0).any(1).double().mean())
        print(f"[phase 1] substep (K3) {label}: " + json.dumps(e3)
              + f" (share of λ nonzero {active:.3f}, of envs with a bound row "
              f"nonzero {bound:.3f})")
        print(f"[phase 1] substep_multi (K2) n_sub=1 {label}: " + json.dumps(e2))
        if not all(e <= TOL for e in e3.values()):
            raise AssertionError(f"K3 disagrees with substep_reference on {label}: {e3}")
        # a = (v⁺ − v)/dt carries v's error ÷ dt; τ is relative to its size
        tau_scale = max(1.0, r2[6].abs().max().item())
        if not (all(e2[n] <= TOL for n in names) and e2["a"] <= TOL / dt
                and e2["tau"] <= TOL * tau_scale):
            raise AssertionError(f"K2 (n_sub=1) disagrees with the plain version on {label}: {e2}")
        if B == B_MAIN:
            _k3_equals_k2("anymal", spec, (q, v, cmd, lam0, wrench))
            worst["substep"] = max(e3[n] for n in names)
            worst["substep_multi"] = max(e2[n] for n in names)

    # a whole env step (4 substeps): f32 rounding compounds over substeps
    # in any f32 version, so the float64 plain version is the yardstick
    # (`_gate_vs_f64`)
    eng64 = _anymal_engine(dev, dtype=torch.float64)
    q, v, cmd, lam0, wrench = _substep_inputs(eng, gen, B_MAIN)
    k2 = substep_batched_multi(spec, 4, q, v, cmd, lam0, wrench)
    p32 = substep_multi_reference(spec, 4, q, v, cmd, lam0, wrench)
    p64 = substep_multi_reference(
        eng64.substep_spec, 4, *(x.double() for x in (q, v, cmd, lam0, wrench))
    )
    torch.cuda.synchronize()
    gates = {n: _gate_vs_f64(f"K2 n_sub=4 {n}", k2[i], p32[i], p64[i])
             for i, n in enumerate(names) if n != "residual"}
    print("[phase 1] substep_multi (K2) n_sub=4 B=4096 vs the f64 plain version: "
          + json.dumps(gates))
    return worst


def _half_turn(q, gen, lo, hi):
    """Turn the bases of envs [lo, hi) half a turn (±1–11 mrad) about z:
    the IMU quaternion then comes from the z candidate with w ≈ ±0.5–5e-3
    (away from 0, where any two float32 versions could pick either sign)."""
    from jiminy_tpu_torch.math import so3

    n, dev = hi - lo, q.device
    kw = dict(generator=gen, device=dev)
    side = torch.where(torch.rand(n, **kw) < 0.5, -1.0, 1.0)
    yaw = torch.pi + side * (1e-3 + 1e-2 * torch.rand(n, **kw))
    zq = torch.stack([torch.zeros(n, device=dev), torch.zeros(n, device=dev),
                      torch.sin(yaw / 2), torch.cos(yaw / 2)], 1)
    q[lo:hi, 3:7] = so3.quat_normalize(so3.quat_mul(zq, q[lo:hi, 3:7]))


def _reading_scale(sens, ref):
    """(n_buf,) scale: for each reading (a group's dim), max(1, max |ref's
    values of it| over envs, sensors and slots). The reference scales each
    group by its largest value (tests/test_sensor_kernel.py); per reading
    is stricter, so the accelerometer's 10² m/s² does not hide an error in
    the quaternion or the gyro of the same group."""
    out, o = [], 0
    B = ref.shape[0]
    for g in sens.suite.groups:
        n = g.ns * g.buf_len * g.dim
        blk = ref[:, o:o + n].reshape(B, g.ns, g.buf_len, g.dim).abs()
        per_dim = blk.amax(dim=(0, 1, 2)).clamp(min=1.0).double()
        out.append(per_dim.expand(g.ns, g.buf_len, g.dim).reshape(-1))
        o += n
    return torch.cat(out)


def _sensor_inputs(eng, sens, gen, B, n_upd):
    """_substep_inputs, a quarter of the bases turned half a turn about z,
    ring buffers of distinct slots (the reset fill plus noise) and the
    corruption of ``n_upd`` updates."""
    suite = sens.suite
    q, v, cmd, lam0, wrench = _substep_inputs(eng, gen, B)
    _half_turn(q, gen, B // 4, B // 2)
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
    bufs = bufs + 0.1 * torch.randn(bufs.shape, generator=gen, device=bufs.device)
    eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_upd)], 1)
    return q, v, cmd, lam0, wrench, bufs, eps


def phase_sensors_vs_plain(dev) -> float:
    """K2 with the sensor stage against its plain version; returns the
    worst error at n_sub = 1, B = 4096 (q, v, λ, impulses and the scaled
    buffers)."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        sensor_stage_reference,
        substep_batched_multi,
        substep_multi_reference,
    )

    eng = _anymal_engine(dev)
    eng64 = _anymal_engine(dev, dtype=torch.float64)
    spec, dt = eng.substep_spec, eng.substep_spec.dt
    sens = SensorKernelSpec(eng.tree, _anymal_suite(dev), 1)
    sens64 = SensorKernelSpec(eng64.tree, _anymal_suite(dev, torch.float64), 1)
    gen = torch.Generator(device=dev).manual_seed(13)
    names = ("q", "v", "lam", "residual", "impulse", "a", "tau")
    worst = 0.0
    for label, B in ((f"B={B_MAIN}", B_MAIN), ("ragged B=1000", 1000)):
        q, v, cmd, lam0, wrench, bufs, eps = _sensor_inputs(eng, sens, gen, B, 1)
        k = substep_batched_multi(spec, 1, q, v, cmd, lam0, wrench, sensors=sens, bufs=bufs, eps=eps)
        r = substep_multi_reference(spec, 1, q, v, cmd, lam0, wrench, sensors=sens, bufs=bufs, eps=eps)
        bare = substep_batched_multi(spec, 1, q, v, cmd, lam0, wrench)
        torch.cuda.synchronize()
        e = {n: _max_err(a, b) for n, a, b in zip(names, k, r)}
        scale = _reading_scale(sens, r[7])
        e["bufs_scaled"] = ((k[7].double() - r[7].double()).abs() / scale).max().item()
        e["bufs_abs"] = _max_err(k[7], r[7])
        # the stage alone: the plain stage in float64 from the kernel's own
        # accepted state (q⁺, v⁺, a, impulses, τ are what its stage read),
        # element by element: |k − r| ≤ 1e-4·max(1, |r|)
        stage = sensor_stage_reference(sens64, *(x.double() for x in (k[0], k[1], k[5], k[4] / dt,
                                                                       k[6], eps, bufs)))
        e["bufs_vs_stage_relative"] = ((k[7].double() - stage).abs()
                                       / stage.abs().clamp(min=1.0)).max().item()
        same = all(torch.equal(k[i], bare[i]) for i in range(7))
        imu_w = r[7][B // 4:B // 2, 3].abs()
        print(f"[phase 1] substep_multi with sensors (K2) n_sub=1 {label}: " + json.dumps(e)
              + f" (equal to the sensor-free K2: {same}; half-turned envs' pushed IMU |w| "
              f"{imu_w.min().item():.3g}–{imu_w.max().item():.3g})")
        tau_scale = max(1.0, r[6].abs().max().item())
        ok = (all(e[n] <= TOL for n in ("q", "v", "lam", "residual", "impulse"))
              and e["a"] <= TOL / dt and e["tau"] <= TOL * tau_scale and e["bufs_scaled"] <= TOL
              and e["bufs_vs_stage_relative"] <= TOL)
        if not (ok and same):
            raise AssertionError(f"K2 with sensors (n_sub=1) disagrees with the plain version "
                                 f"on {label}: {e}, equal to the sensor-free K2: {same}")
        if B == B_MAIN:
            worst = max(e["q"], e["v"], e["lam"], e["impulse"], e["bufs_scaled"])

    # a whole env step, and the k_obs = 2 schedule through the engine:
    # float64 plain version as the yardstick, env by env
    for k_obs, period, delay in ((1, 5e-3, 0.004), (2, 1e-2, 0.008)):
        suite = _anymal_suite(dev, period=period, delay=delay)
        sens = SensorKernelSpec(eng.tree, suite, k_obs)
        sens64 = SensorKernelSpec(eng64.tree, suite.to(dtype=torch.float64), k_obs)
        n_upd = 4 // k_obs
        q, v, cmd, lam0, wrench, bufs, eps = _sensor_inputs(eng, sens, gen, B_MAIN, n_upd)
        if k_obs == 1:
            before = _counts()["substep_multi_sensors"]
            k = substep_batched_multi(spec, 4, q, v, cmd, lam0, wrench, sensors=sens, bufs=bufs, eps=eps)
            k = (k[0], k[1], k[2], k[4], k[7])
        else:
            from jiminy_tpu_torch.engine.engine import SimState

            z = torch.zeros(B_MAIN, device=dev)
            sim = SimState(t=z, q=q, v=v, contact_forces=torch.zeros(B_MAIN, 4, 3, device=dev),
                           solver_residual=z, lam=lam0, a=torch.zeros_like(v), tau=torch.zeros_like(v))
            before = _counts()["substep_multi_sensors"]
            out, kb = eng.step_with_sensors(sim, cmd, 4, suite, bufs, eps, k_obs=2, base_wrench=wrench)
            k = (out.q, out.v, out.lam, out.contact_forces * dt, kb)
        launched = _counts()["substep_multi_sensors"] - before
        p32 = substep_multi_reference(spec, 4, q, v, cmd, lam0, wrench, sensors=sens, bufs=bufs, eps=eps)
        p64 = substep_multi_reference(eng64.substep_spec, 4, *(x.double() for x in (q, v, cmd, lam0, wrench)),
                                      sensors=sens64, bufs=bufs.double(), eps=eps.double())
        torch.cuda.synchronize()
        scale = _reading_scale(sens, p64[7])
        gates = {n: _gate_vs_f64(f"K2 sensors k_obs={k_obs} n_sub=4 {n}", k[i], p32[j], p64[j])
                 for i, (n, j) in enumerate((("q", 0), ("v", 1), ("lam", 2), ("impulse", 4)))}
        gates["bufs_scaled"] = _gate_vs_f64(f"K2 sensors k_obs={k_obs} n_sub=4 bufs",
                                            k[4].double() / scale, p32[7].double() / scale,
                                            p64[7] / scale)
        print(f"[phase 1] substep_multi with sensors (K2) k_obs={k_obs} n_sub=4 B={B_MAIN} "
              f"({launched} launch) vs the f64 plain version: " + json.dumps(gates))
        if launched != 1:
            raise AssertionError(f"expected one launch of K2 with the sensor stage, saw {launched}")
    return worst


def phase_ground_vs_plain(dev) -> dict:
    """K3, K2 and K2 with the sensor stage on per-env analytic grounds
    (their GEN instantiations) against their plain versions, for each
    ground kind, from the same inputs: at n_sub = 1, B = 4096 and a ragged
    B = 1000, and at n_sub = 4, B = 4096. On terrain one substep is not
    well posed at 1e-4 in every env (deeper and more numerous contacts:
    in a few envs of 1000 the plain float32 version is itself 1e-4–1e-3
    from float64), so each output is held env by env against the float64
    plain version (`_gate_vs_f64`) at both depths; the actuation torque,
    computed from the inputs alone, within 1e-4 of its size; and the
    sensor variant's q, v, λ, impulses, a and τ bit-equal to the
    sensor-free K2's. Returns each kernel's worst |Δ| against the plain
    float32 version at n_sub = 1, B = 4096 over the three grounds."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    names = ("q", "v", "lam", "residual", "impulse")
    worst = {"substep_ground": 0.0, "substep_multi_ground": 0.0,
             "substep_multi_sensors_ground": 0.0}
    gen = torch.Generator(device=dev).manual_seed(21)
    suite, suite64 = _anymal_suite(dev), _anymal_suite(dev, torch.float64)
    for kind in GROUND_KINDS:
        template = _ground_template(kind, dev)
        eng = _anymal_engine(dev, ground=template)
        eng64 = _anymal_engine(dev, torch.float64, ground=template)
        spec, dt = eng.substep_spec, eng.substep_spec.dt
        sens = SensorKernelSpec(eng.tree, suite, 1)
        for label, B in ((f"B={B_MAIN}", B_MAIN), ("ragged B=1000", 1000)):
            args, gc, steep = _ground_inputs(eng, kind, gen, B)
            q, v, cmd, lam0, wrench = args
            tau = eng._joint_torque(cmd, q, v)
            bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
            sw = dict(sensors=sens, bufs=bufs, eps=suite.sample_eps(gen, B))
            before = _counts()
            k3 = substep_batched(spec, q, v, tau, lam0, wrench, gc=gc)
            k2 = substep_batched_multi(spec, 1, *args, gc=gc)
            ks = substep_batched_multi(spec, 1, *args, gc=gc, **sw)
            launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
            r3 = substep_reference(spec, q, v, tau, lam0, wrench, gc=gc)
            r2 = substep_multi_reference(spec, 1, *args, gc=gc, **sw)
            a64 = [x.double() for x in args]
            r3_64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3],
                                      a64[4], gc=gc.double())
            r2_64 = substep_multi_reference(
                eng64.substep_spec, 1, *a64, gc=gc.double(),
                sensors=SensorKernelSpec(eng64.tree, suite64, 1), bufs=bufs.double(),
                eps=sw["eps"].double())
            torch.cuda.synchronize()
            e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
            e2 = {n: _max_err(a, b) for n, a, b in zip(names + ("a", "tau"), k2, r2)}
            scale = _reading_scale(sens, r2_64[7])
            es = {"bufs_scaled": ((ks[7].double() - r2[7].double()).abs() / scale).max().item()}
            same = all(torch.equal(ks[i], k2[i]) for i in range(7))
            gates = {}
            for kname, k, p32, p64 in (("K3", k3, r3, r3_64), ("K2", k2, r2, r2_64)):
                for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
                    gates[f"{kname} {n}"] = _gate_vs_f64(f"{kname} {kind} {label} n_sub=1 {n}",
                                                         k[i], p32[i], p64[i])
            gates["K2 sensors bufs_scaled"] = _gate_vs_f64(
                f"K2 sensors {kind} {label} n_sub=1 bufs", ks[7].double() / scale,
                r2[7].double() / scale, r2_64[7] / scale)
            print(f"[phase 1] {kind} ground {label}: max |kernel − plain f32|: K3 {json.dumps(e3)}; "
                  f"K2 n_sub=1 {json.dumps(e2)}; K2 with sensors {json.dumps(es)}, physics equal to "
                  f"the sensor-free K2: {same}; contacts on a steep normal {steep}/{4 * B}; "
                  f"launches {json.dumps(launched)}")
            print(f"[phase 1] {kind} ground {label}, n_sub=1 vs the f64 plain version: "
                  + json.dumps(gates))
            tau_scale = max(1.0, r2[6].abs().max().item())
            if not (e2["tau"] <= TOL * tau_scale and same):
                raise AssertionError(f"{kind} ground, {label}: K2's τ off by {e2['tau']} or the "
                                     f"sensor variant's physics not the sensor-free K2's ({same})")
            if launched != {"substep_ground": 1, "substep_multi_ground": 1,
                            "substep_multi_sensors_ground": 1}:
                raise AssertionError(f"{kind} ground: unexpected launches {launched}")
            if kind == "stairs" and steep == 0:
                raise AssertionError("no contact of the stairs inputs took the steep switch")
            if B == B_MAIN:
                _k3_equals_k2(f"{kind} ground", spec, args, gc=gc)
                worst["substep_ground"] = max(worst["substep_ground"], *(e3[n] for n in names))
                worst["substep_multi_ground"] = max(worst["substep_multi_ground"],
                                                    *(e2[n] for n in names))
                worst["substep_multi_sensors_ground"] = max(
                    worst["substep_multi_sensors_ground"], *(e2[n] for n in names),
                    es["bufs_scaled"])

        # a whole env step: env by env against the float64 plain version
        args, gc, _ = _ground_inputs(eng, kind, gen, B_MAIN)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B_MAIN), args[0], args[1]))
        eps = torch.cat([suite.sample_eps(gen, B_MAIN) for _ in range(4)], 1)
        sw = dict(sensors=sens, bufs=bufs, eps=eps)
        k2 = substep_batched_multi(spec, 4, *args, gc=gc)
        ks = substep_batched_multi(spec, 4, *args, gc=gc, **sw)
        p32 = substep_multi_reference(spec, 4, *args, gc=gc, **sw)
        p64 = substep_multi_reference(
            eng64.substep_spec, 4, *(x.double() for x in args), gc=gc.double(),
            sensors=SensorKernelSpec(eng64.tree, suite64, 1), bufs=bufs.double(),
            eps=eps.double())
        torch.cuda.synchronize()
        scale = _reading_scale(sens, p64[7])
        gates = {f"K2 {n}": _gate_vs_f64(f"K2 {kind} n_sub=4 {n}", k2[i], p32[i], p64[i])
                 for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))}
        gates.update({f"K2 sensors {n}": _gate_vs_f64(f"K2 sensors {kind} n_sub=4 {n}", ks[i],
                                                      p32[i], p64[i])
                      for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))})
        gates["K2 sensors bufs_scaled"] = _gate_vs_f64(
            f"K2 sensors {kind} n_sub=4 bufs", ks[7].double() / scale,
            p32[7].double() / scale, p64[7] / scale)
        print(f"[phase 1] {kind} ground, n_sub=4 B={B_MAIN} vs the f64 plain version: "
              + json.dumps(gates))
    return worst


# model randomization (B.5): the slice's ranges (examples/train.py
# --randomize 0.2) widened to the armature and the friction, which the
# slice leaves at 1, so that every field of the row moves the physics
RAND_RANGES = dict(mass_scale=(0.8, 1.2), com_offset=(-0.02, 0.02), inertia_scale=(0.8, 1.2),
                   armature_scale=(0.7, 1.3), motor_gain=(0.9, 1.1),
                   motor_friction_scale=(0.5, 2.0))
NOMINAL_TOL = 1e-5  # the nominal row rebuilds I as I_c + shift: ~1 ulp off the baked inertia


def _rand_params(eng, gen, B, nominal=False):
    """Each env's packed model parameters (B, n_mp): drawn uniform over
    ``RAND_RANGES``, a quarter of the envs with every value at one end of
    its range; or the nominal ones."""
    from jiminy_tpu_torch.engine.randomization import ModelParams

    t, nm = eng.tree, eng.motors.nm
    if nominal:
        return eng._pack_model_params(ModelParams.nominal(t, eng.motors, B))
    shapes = dict(mass_scale=(B, t.nb), com_offset=(B, t.nb, 3), inertia_scale=(B, t.nb),
                  armature_scale=(B, t.nv), motor_gain=(B, nm), motor_friction_scale=(B, nm))
    kw = dict(generator=gen, device=eng.device)
    fields = {}
    for k, (lo, hi) in RAND_RANGES.items():
        x = lo + (hi - lo) * torch.rand(shapes[k], **kw)
        ends = lo + (hi - lo) * (torch.rand(shapes[k], **kw) < 0.5).to(x.dtype)
        x[:B // 4] = ends[:B // 4]
        fields[k] = x
    return eng._pack_model_params(ModelParams(**fields))


def _rand_flops(spec) -> int:
    """What the model parameters add to one env's K2 substep: the gain and
    the friction scale, a multiply each per motor (`jt_torque`); reading
    the inertials from the row instead of the spec moves data and does
    no arithmetic, so K3 adds nothing."""
    return 2 * spec.torque.nm


def _nominal_gap(a, b) -> float:
    """max |a − b| over the outputs q, v, λ, impulses."""
    return max(_max_err(a[i], b[i]) for i in (0, 1, 2, 4))


def phase_rand_vs_plain(dev) -> dict:
    """The randomized instantiations (each env's model parameters) against
    their plain versions from the same inputs and parameters
    (``_rand_params``), and against the nominal kernels:

    - flat ground, K3, K2 and K2 with the sensor stage at n_sub = 1,
      B = 4096 and a ragged B = 1000: within 1e-4 as the nominal kernels
      (phase 1), the sensor variant's physics bit-equal to the
      sensor-free one's; with the nominal parameters, within 1e-5 of the
      unrandomized kernels;
    - one state in every env and different parameters: the envs step
      apart (v by more than 1e-3 from env 0's in most envs);
    - K2 at n_sub = 4 env by env against the float64 plain version;
    - the Fourier ground (per-env coefficients as phase 1's), K3, K2 and
      K2 with the sensor stage at n_sub = 1 (both B) and the sensor
      variant at n_sub = 4, env by env against the float64 plain version
      (as the nominal ground kernels); the nominal parameters within 1e-5
      of the unrandomized ground kernels.

    Returns each instantiation's worst |kernel − plain f32| at n_sub = 1,
    B = 4096."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
        unpack_model_params,
    )

    names = ("q", "v", "lam", "residual", "impulse")
    worst = {}
    gen = torch.Generator(device=dev).manual_seed(31)
    suite, suite64 = _anymal_suite(dev), _anymal_suite(dev, torch.float64)
    for kind in ("flat", "fourier"):
        ground = _ground_template(kind, dev) if kind != "flat" else None
        eng = _anymal_engine(dev, ground=ground)
        eng64 = _anymal_engine(dev, torch.float64, ground=ground)
        spec, dt = eng.substep_spec, eng.substep_spec.dt
        sens = SensorKernelSpec(eng.tree, suite, 1)
        sens64 = SensorKernelSpec(eng64.tree, suite64, 1)
        sfx = "" if kind == "flat" else "_ground"
        for label, B in ((f"B={B_MAIN}", B_MAIN), ("ragged B=1000", 1000)):
            if kind == "flat":
                args, gc = _substep_inputs(eng, gen, B), None
            else:
                args, gc, _ = _ground_inputs(eng, kind, gen, B)
            q, v, cmd, lam0, wrench = args
            bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
            sw = dict(sensors=sens, bufs=bufs, eps=suite.sample_eps(gen, B))
            mp = _rand_params(eng, gen, B)
            tau = eng._joint_torque(cmd, q, v, unpack_model_params(spec, mp)[1])
            before = _counts()
            k3 = substep_batched(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
            k2 = substep_batched_multi(spec, 1, *args, gc=gc, mp=mp)
            ks = substep_batched_multi(spec, 1, *args, gc=gc, mp=mp, **sw)
            launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
            r3 = substep_reference(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
            r2 = substep_multi_reference(spec, 1, *args, gc=gc, mp=mp, **sw)
            # the nominal parameters through the randomized kernels
            mpn = _rand_params(eng, gen, B, nominal=True)
            tau_n = eng._joint_torque(cmd, q, v)
            nominal = {
                "K3": _nominal_gap(substep_batched(spec, q, v, tau_n, lam0, wrench, gc=gc, mp=mpn),
                                   substep_batched(spec, q, v, tau_n, lam0, wrench, gc=gc)),
                "K2": _nominal_gap(substep_batched_multi(spec, 1, *args, gc=gc, mp=mpn),
                                   substep_batched_multi(spec, 1, *args, gc=gc)),
                "K2 sensors": _nominal_gap(
                    substep_batched_multi(spec, 1, *args, gc=gc, mp=mpn, **sw),
                    substep_batched_multi(spec, 1, *args, gc=gc, **sw)),
            }
            torch.cuda.synchronize()
            e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
            e2 = {n: _max_err(a, b) for n, a, b in zip(names + ("a", "tau"), k2, r2)}
            scale = _reading_scale(sens, r2[7])
            es = {"bufs_scaled": ((ks[7].double() - r2[7].double()).abs() / scale).max().item()}
            same = all(torch.equal(ks[i], k2[i]) for i in range(7))
            print(f"[phase 1] randomized, {kind} ground, {label}: max |kernel − plain f32|: K3 "
                  f"{json.dumps(e3)}; K2 n_sub=1 {json.dumps(e2)}; K2 with sensors "
                  f"{json.dumps(es)}, physics equal to the sensor-free K2: {same}; nominal "
                  f"parameters vs the unrandomized kernels {json.dumps(nominal)}; launches "
                  f"{json.dumps(launched)}")
            want = {f"rand_substep{sfx}": 1, f"rand_substep_multi{sfx}": 1,
                    f"rand_substep_multi_sensors{sfx}": 1}
            if launched != want:
                raise AssertionError(f"randomized {kind}: unexpected launches {launched}")
            tau_scale = max(1.0, r2[6].abs().max().item())
            if not (e2["tau"] <= TOL * tau_scale and same):
                raise AssertionError(f"randomized {kind} {label}: K2's τ off by {e2['tau']} or the "
                                     f"sensor variant's physics not the sensor-free K2's ({same})")
            if max(nominal.values()) > NOMINAL_TOL:
                raise AssertionError(f"randomized {kind} {label}: the nominal parameters are more "
                                     f"than {NOMINAL_TOL} off the unrandomized kernels: {nominal}")
            if kind == "flat":
                if not (all(e3[n] <= TOL for n in names) and all(e2[n] <= TOL for n in names)
                        and e2["a"] <= TOL / dt and es["bufs_scaled"] <= TOL):
                    raise AssertionError(f"randomized kernels disagree with their plain versions "
                                         f"on {label}: K3 {e3}, K2 {e2}, K2 sensors {es}")
            else:  # on terrain, env by env against float64 (phase_ground_vs_plain)
                a64 = [x.double() for x in args]
                r3_64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3],
                                          a64[4], gc=gc.double(), mp=mp.double())
                r2_64 = substep_multi_reference(
                    eng64.substep_spec, 1, *a64, gc=gc.double(), mp=mp.double(), sensors=sens64,
                    bufs=bufs.double(), eps=sw["eps"].double())
                torch.cuda.synchronize()
                gates = {}
                for kname, k, p32, p64 in (("K3", k3, r3, r3_64), ("K2", k2, r2, r2_64)):
                    for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
                        gates[f"{kname} {n}"] = _gate_vs_f64(
                            f"randomized {kname} {kind} {label} n_sub=1 {n}", k[i], p32[i], p64[i])
                s64 = _reading_scale(sens, r2_64[7])
                gates["K2 sensors bufs_scaled"] = _gate_vs_f64(
                    f"randomized K2 sensors {kind} {label} n_sub=1 bufs", ks[7].double() / s64,
                    r2[7].double() / s64, r2_64[7] / s64)
                print(f"[phase 1] randomized, {kind} ground, {label}, n_sub=1 vs the f64 plain "
                      "version: " + json.dumps(gates))
            if B == B_MAIN:
                _k3_equals_k2(f"randomized, {kind} ground", spec, args, gc=gc, mp=mp)
                worst[f"rand_substep{sfx}"] = max(e3[n] for n in names)
                worst[f"rand_substep_multi{sfx}"] = max(e2[n] for n in names)
                worst[f"rand_substep_multi_sensors{sfx}"] = max(
                    max(e2[n] for n in names), es["bufs_scaled"])

        # a whole env step, env by env against the float64 plain version
        if kind == "flat":
            args, gc = _substep_inputs(eng, gen, B_MAIN), None
        else:
            args, gc, _ = _ground_inputs(eng, kind, gen, B_MAIN)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B_MAIN), args[0], args[1]))
        eps = torch.cat([suite.sample_eps(gen, B_MAIN) for _ in range(4)], 1)
        sw = dict(sensors=sens, bufs=bufs, eps=eps)
        mp = _rand_params(eng, gen, B_MAIN)
        g64 = None if gc is None else gc.double()
        ks = substep_batched_multi(spec, 4, *args, gc=gc, mp=mp, **sw)
        p32 = substep_multi_reference(spec, 4, *args, gc=gc, mp=mp, **sw)
        p64 = substep_multi_reference(
            eng64.substep_spec, 4, *(x.double() for x in args), gc=g64, mp=mp.double(),
            sensors=sens64, bufs=bufs.double(), eps=eps.double())
        torch.cuda.synchronize()
        scale = _reading_scale(sens, p64[7])
        gates = {f"K2 sensors {n}": _gate_vs_f64(f"randomized K2 sensors {kind} n_sub=4 {n}",
                                                 ks[i], p32[i], p64[i])
                 for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))}
        gates["K2 sensors bufs_scaled"] = _gate_vs_f64(
            f"randomized K2 sensors {kind} n_sub=4 bufs", ks[7].double() / scale,
            p32[7].double() / scale, p64[7] / scale)
        if kind == "flat":
            k2 = substep_batched_multi(spec, 4, *args, mp=mp)
            torch.cuda.synchronize()
            gates.update({f"K2 {n}": _gate_vs_f64(f"randomized K2 {kind} n_sub=4 {n}",
                                                  k2[i], p32[i], p64[i])
                          for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))})
            # one state in every env, different parameters: the envs step apart
            one = [x[:1].expand_as(x).contiguous() for x in args]
            v_one = substep_batched_multi(spec, 4, *one, mp=mp)[1].double()
            apart = (v_one - v_one[:1]).abs().amax(dim=1)
            share = float((apart[1:] > 1e-3).double().mean())
            print(f"[phase 1] randomized K2, one state in every env, n_sub=4: share of envs whose v "
                  f"is more than 1e-3 from env 0's {share:.4f} (max {apart.max().item():.3g})")
            if share < 0.5:
                raise AssertionError(f"randomization does not move the physics: {share}")
        print(f"[phase 1] randomized, {kind} ground, n_sub=4 B={B_MAIN} vs the f64 plain version: "
              + json.dumps(gates))
    return worst


# ---- Cassie (A.12 with B.9): pushrod closed loops and shin springs in
# the large frame of the whole-substep kernels
CASSIE_KW = dict(sim_dt=2e-3, target_speed=0.4, pgs_iters=8)  # examples/train.py --env cassie
CASSIE_SENSOR_KW = dict(CASSIE_KW, observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                        encoder_noise=0.005)  # cassie_sensors_run's sensing
CASSIE_PUSH_KW = dict(CASSIE_KW, observe="state", push_magnitude=50.0,
                      push_duration=0.2)  # cassie_push_robust_run's pushes
ROD_TOL = 1e-3  # the reference's TestCassie bound on |d − d₀|, m


@functools.cache
def _cassie_model(dev, flexibility=False):
    """(tree, motors, suite, pushrods, stand pose) of the biped with
    cassie_sensors_run's suite (2 ms period, 4 ms delay, noise 0.02 /
    0.005); with ``flexibility`` the flexible-hip model (its suite: the
    pelvis and both hip IMUs, the encoders)."""
    from jiminy_tpu_torch.models.biped import make_cassie

    return make_cassie(sensor_period=2e-3, sensor_delay=0.004, imu_noise=0.02,
                       encoder_noise=0.005, flexibility=flexibility, device=dev)


def _cassie_engine(dev, dtype=torch.float32, residual=True, fusion=True, solver="substep",
                   pairs=(), flexibility=False):
    """CassieEnv's engine (PD kp 150, kd 6, 2 ms, 8 sweeps, the pushrods),
    with the collision ``pairs``, on the flexible-hip model with
    ``flexibility``; in float64 on the float32 model's constants."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController

    tree, motors, _, rods, _ = _cassie_model(dev, flexibility)
    opts = EngineOptions(contact_model="constraint", dt=2e-3, pgs_iters=8,
                         compute_solver_residual=residual,
                         substep_fusion=fusion, constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(150.0, 6.0), constraints=rods,
                  collision_pairs=pairs, device=dev)


def _cassie_inputs(engine, gen, B, flexibility=False):
    """Cassie states around the stand pose (of the flexible-hip model with
    ``flexibility``, its hips at the identity): the motor joints ±0.05 rad
    (the pushrod loops open by millimetres), the shin springs ±0.05 rad,
    in a quarter of the envs both hip rolls within 1 cm·rad of a limit
    (either side, so that the bounds rows bind), the base 1 cm low to
    0.5 cm high (toes penetrating, hovering within the margin and clear)
    and tilted, v ~ 0.3·N(0, 1), λ0 ≥ 0, PD targets ±0.1 rad around the
    joints, a root wrench of ~5 N·m and ~20 N."""
    t = engine.tree
    dev = engine.device
    kw = dict(generator=gen, device=dev)
    stand = _cassie_model(dev, flexibility)[4]
    qi = list(engine.motors.q_idx)
    q = torch.as_tensor(stand, device=dev).repeat(B, 1)
    q[:, qi] += 0.1 * torch.rand(B, len(qi), **kw) - 0.05
    sp = [t.q_off[t.joint_index(n)] for n in ("L_shin_spring", "R_shin_spring")]
    q[:, sp] += 0.1 * torch.rand(B, 2, **kw) - 0.05
    roll = [t.q_off[t.joint_index(n)] for n in ("L_hip_roll", "R_hip_roll")]
    side = torch.where(torch.rand(B // 4, 2, **kw) < 0.5, -1.0, 1.0)
    q[:B // 4, roll] = side * (t.q_max[roll].to(dev) + 0.02 * torch.rand(B // 4, 2, **kw) - 0.01)
    q[:, 2] += 0.015 * torch.rand(B, **kw) - 0.01
    quat = torch.cat([0.06 * torch.rand(B, 3, **kw) - 0.03, torch.ones(B, 1, device=dev)], 1)
    q[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    v = 0.3 * torch.randn(B, t.nv, **kw)
    lam0 = (0.05 * torch.randn(B, engine.nc, **kw)).abs()
    cmd = q[:, qi] + 0.2 * torch.rand(B, len(qi), **kw) - 0.1
    wrench = torch.cat([5.0 * torch.randn(B, 3, **kw), 20.0 * torch.randn(B, 3, **kw)], 1)
    return q, v, cmd, lam0, wrench


# On Cassie no float32 version of one substep is within 1e-4 of float64:
# its mass matrix's condition is of order 1e4 (a 0.3 kg foot of 1e-3 kg·m² at
# the end of a 15-body chain, PD gains of 150), so float32 rounding alone
# puts the plain version 1e-4–3e-3 from float64 in v in most envs, and
# two float32 versions fall on either side of it at random. `_gate_vs_f64`'s
# env-by-env rule (the kernel within 2 × the plain version's distance
# + 1e-4 in all but 1 % of the envs) then fails on chance alone. So the
# kernel is held to float64 by the distribution of its per-env distance
# beside the plain float32 version's: at the 50th, 90th and 99th
# percentiles within 1.5 × the plain version's + 1e-5, the worst env
# within 2 × the plain version's worst + 1e-4, and no more envs off by
# 1e-4 than 1.5 × the plain version's + 4. A fault of one mechanism (a
# row, its target, the springs) moves every env that uses it and the
# distribution with it.
DIST_QUANTILES = (0.5, 0.9, 0.99)


def _gate_dist_vs_f64(label, k, p32, p64, check=True, worst_of=None) -> dict:
    """K2's (or K3's) output ``k`` against the plain version in float32
    and float64 on the same inputs, by the distribution rules above;
    raises when one fails (with ``check``; else only reports). ``worst_of``
    (B,) bool: the envs the worst-env rule compares (every env if None;
    their count and the kernel's and the plain version's worst over them
    reported as ``worst_env_of``)."""
    dk, dp = _env_err(k, p64), _env_err(p32, p64)
    qs = torch.tensor(DIST_QUANTILES, dtype=torch.float64, device=dk.device)
    qk, qp = torch.quantile(dk, qs), torch.quantile(dp, qs)
    g = {
        "kernel_vs_f64_p50_p90_p99_max": qk.tolist() + [dk.max().item()],
        "plain_f32_vs_f64_p50_p90_p99_max": qp.tolist() + [dp.max().item()],
        "kernel_vs_plain_f32": _env_err(k, p32).max().item(),
        "envs_kernel_over_1e-4": int((dk > TOL).sum()),
        "envs_plain_over_1e-4": int((dp > TOL).sum()),
    }
    if not check:
        return g
    if bool((qk > 1.5 * qp + 1e-5).any()):
        raise AssertionError(f"{label}: the kernel's distance to f64 exceeds 1.5 × the plain "
                             f"f32 version's + 1e-5 at a percentile: {g}")
    if worst_of is not None:
        dk, dp = dk[worst_of], dp[worst_of]
        g["worst_env_of"] = [int(worst_of.sum())] + [d.max().item() if d.numel() else 0.0
                                                     for d in (dk, dp)]
    if dk.numel() and dk.max().item() > 2.0 * dp.max().item() + TOL:
        raise AssertionError(f"{label}: the kernel's worst env is further from f64 than 2 × the "
                             f"plain f32 version's + 1e-4: {g}")
    if g["envs_kernel_over_1e-4"] > 1.5 * g["envs_plain_over_1e-4"] + 4:
        raise AssertionError(f"{label}: the kernel is off f64 by more than 1e-4 in more envs "
                             f"than 1.5 × the plain f32 version + 4: {g}")
    return g


def _held(label, outs, p32, p64, scale=None):
    """Each kernel's outputs of ``outs`` {name: outputs} held to the
    float64 plain version by `_gate_dist_vs_f64` on q, v, λ, the impulses
    and, where present, the buffers divided by ``scale``."""
    gates = {}
    for kname, k in outs.items():
        for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
            gates[f"{kname} {n}"] = _gate_dist_vs_f64(f"{label} {kname} {n}", k[i], p32[i], p64[i])
        if len(k) > 7:
            gates[f"{kname} bufs_scaled"] = _gate_dist_vs_f64(
                f"{label} {kname} bufs", k[7].double() / scale, p32[7].double() / scale,
                p64[7] / scale)
    return gates


def _world_loop_toy(dev):
    """tests/test_constraints.py's two-pendulum loop with the second tip
    tied to a frame of the world (body −1): nb 2, nv 2, one distance row,
    no contact (ncp 0, no contact color) and no bounds row."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.constraints import DistanceConstraint

    place = TreeBuilder.make_placement
    b = TreeBuilder()
    b.add_body("l1", -1, JointType.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1))
    b.add_body("l2", -1, JointType.REVOLUTE, placement=place((0.5, 0, 0)), axis=(0, 1, 0),
               mass=1.0, com=(0, 0, -1))
    f1 = b.add_frame("tip1", 0, place((0, 0, -1)))
    f2 = b.add_frame("anchor", -1, place((0.5, 0, -1)))
    rod = DistanceConstraint(f1, f2, distance=0.6, baumgarte_freq=20.0)
    return Engine(b.build(device=dev), EngineOptions(contact_model="constraint", dt=1e-3,
                                                     constraint_solver="substep"),
                  constraints=(rod,), device=dev)


def _ab_cassie_substeps(env, state, act_gen, dev, kw=None, label="cassie state path"):
    """One env step of a Cassie state path (the env that ``kw`` builds;
    the plain state path's by default) from its own state, substep by
    substep, each substep feeding K2 (one launch at n_sub = 1) and the
    inline plain engine in float32 and float64 the same inputs: K2 held to
    the float64 engine by `_gate_dist_vs_f64` on q, v and λ. With
    collision pairs the worst-env rule compares the envs with a pair row
    active at the substep's start: on rollout states it fails on chance
    alone elsewhere (in a run of this script on an NVIDIA H100 80GB HBM3,
    700 W, one env of 4096 sat 6.3e-3 m/s from f64 in one substep against
    the plain version's worst 2.2e-3, the same excursion, to the digit, as
    on the same rollout without the pairs; ROADMAP C.2), and a fault of the
    pair rows shows in those envs."""
    from jiminy_tpu_torch.envs import CassieEnv

    inline = CassieEnv(constraint_solver="inline", device=dev,
                       **(kw or dict(CASSIE_KW, observe="state")))
    plain64 = _cassie_engine(dev, torch.float64, residual=False, solver="inline",
                             pairs=env.engine.collision_pairs,
                             flexibility=(kw or {}).get("flexibility", False))
    u = env._action_to_command(_uniform(act_gen, dev, env.motors.nm), state.sim)
    sim, gates = state.sim, {"q": [], "v": [], "lam": []}
    for i in range(env.n_substeps):
        nk = env.engine.step(sim, u, n_substeps=1)
        ni = inline.engine.step(sim, u, n_substeps=1)
        n64 = plain64.step(_as_f64(state.replace(sim=sim)).sim, u.double(), n_substeps=1)
        paired = _active_pair_envs(env.engine, sim.q) if env.engine.collision_pairs else None
        for f, per_sub in gates.items():
            per_sub.append(_gate_dist_vs_f64(f"{label} K2 substep {i} {f}", getattr(nk, f),
                                             getattr(ni, f), getattr(n64, f), worst_of=paired))
        sim = nk
    print(f"[phase 2] {label}, one env step, K2 substep by substep vs the inline engine "
          "in f32 and f64 on the same inputs: " + json.dumps(gates))


def _rod_error(env, sim):
    """|d − d₀| of each pushrod of ``env`` at ``sim``, (B, n_rods)."""
    from jiminy_tpu_torch.core import algos

    xw = algos.forward_kinematics(env.tree, sim.q)
    out = []
    for c in env.engine.constraints:
        p1, p2 = c.points(env.tree, xw, sim.q)
        out.append((torch.linalg.vector_norm(p1 - p2, dim=-1) - c.distance).abs())
    return torch.stack(out, dim=1)


def phase_cassie_vs_plain(dev) -> dict:
    """The kernels on the Cassie spec (two distance rows, the shin springs,
    the large frame) against their plain versions from the same inputs
    (`_cassie_inputs`):

    - K3, K2 and K2 with the sensor stage (IMU + 10 encoders) at n_sub = 1,
      B = 4096 and a ragged B = 1000: the actuation torque (inputs only,
      well posed) within 1e-4 of its size, the sensor variant's q, v, λ,
      impulses, a and τ bit-equal to the sensor-free K2's, and q, v, λ,
      the impulses and the scaled buffers held to the float64 plain
      version by their distribution (`_gate_dist_vs_f64`);
    - K2 over a whole env step (n_sub = 10) bit-equal to ten chained K2
      launches at n_sub = 1 (λ, the distance rows' slots included, carried
      through the launch as through memory), and K2 with the sensor stage
      (an update per substep) bit-equal to it in q, v, λ, impulses, a and
      τ; their distance to the float64 plain version reported: over ten
      substeps from these inputs any two float32 versions part from
      float64 by up to metres per second in a few envs (where an active
      set switches), a chaos no gate can hold (ROADMAP C.2);
    - one randomized K2 launch at n_sub = 1 (the distance rows and springs
      are shared code), likewise; with the nominal parameters within 1e-5
      of the unrandomized K2;
    - K3 on the two-pendulum loop tied to the world (`_world_loop_toy`),
      well posed: within 1e-4 of the plain version on q, v, λ and the
      residual, and the distance row's impulse nonzero.

    Returns each kernel's worst |kernel − plain f32| at n_sub = 1,
    B = 4096."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    eng, eng64 = _cassie_engine(dev), _cassie_engine(dev, torch.float64)
    spec, spec64, dt = eng.substep_spec, eng64.substep_spec, eng.substep_spec.dt
    suite = _cassie_model(dev)[2]
    sens = SensorKernelSpec(eng.tree, suite, 1)
    sens64 = SensorKernelSpec(eng64.tree, suite.to(dtype=torch.float64), 1)
    names = ("q", "v", "lam", "residual", "impulse")
    gen = torch.Generator(device=dev).manual_seed(41)
    worst = {}

    for label, B in ((f"B={B_MAIN}", B_MAIN), ("ragged B=1000", 1000)):
        args = _cassie_inputs(eng, gen, B)
        q, v, cmd, lam0, wrench = args
        tau = eng._joint_torque(cmd, q, v)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
        sw = dict(sensors=sens, bufs=bufs, eps=suite.sample_eps(gen, B))
        before = _counts()
        k3 = substep_batched(spec, q, v, tau, lam0, wrench)
        k2 = substep_batched_multi(spec, 1, *args)
        ks = substep_batched_multi(spec, 1, *args, **sw)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        r3 = substep_reference(spec, q, v, tau, lam0, wrench)
        r2 = substep_multi_reference(spec, 1, *args, **sw)
        a64 = [x.double() for x in args]
        r3_64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4])
        r2_64 = substep_multi_reference(spec64, 1, *a64, sensors=sens64, bufs=bufs.double(),
                                        eps=sw["eps"].double())
        torch.cuda.synchronize()
        e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
        e2 = {n: _max_err(a, b) for n, a, b in zip(names + ("a", "tau"), k2, r2)}
        scale = _reading_scale(sens, r2_64[7])
        es = {"bufs_scaled": ((ks[7].double() - r2[7].double()).abs() / scale).max().item()}
        same = all(torch.equal(ks[i], k2[i]) for i in range(7))
        rods = {"pushrod": float((r3[2][:, :2] != 0).any(1).double().mean()),
                "bound": float((r3[2][:, 2:16] != 0).any(1).double().mean())}
        print(f"[phase 1] cassie {label}: max |kernel − plain f32|: K3 {json.dumps(e3)}; K2 n_sub=1 "
              f"{json.dumps(e2)}; K2 with sensors {json.dumps(es)}, physics equal to the "
              f"sensor-free K2: {same}; share of envs with a pushrod / bound row's λ nonzero "
              f"{rods['pushrod']:.3f} / {rods['bound']:.3f}; launches {json.dumps(launched)}")
        gates = _held(f"cassie {label} n_sub=1", {"K3": k3}, r3, r3_64)
        gates.update(_held(f"cassie {label} n_sub=1", {"K2": k2, "K2 sensors": ks}, r2, r2_64,
                          scale))
        print(f"[phase 1] cassie {label}, n_sub=1 vs the f64 plain version: " + json.dumps(gates))
        tau_scale = max(1.0, r2[6].abs().max().item())
        if not (e2["tau"] <= TOL * tau_scale and same):
            raise AssertionError(f"cassie {label}: K2's τ off by {e2['tau']} or the sensor "
                                 f"variant's physics not the sensor-free K2's ({same})")
        if launched != {"substep": 1, "substep_multi": 1, "substep_multi_sensors": 1}:
            raise AssertionError(f"cassie: unexpected launches {launched}")
        if rods["pushrod"] < 0.5 or rods["bound"] < 0.1:
            raise AssertionError(f"cassie inputs engage too few pushrod or bound rows: {rods}")
        if B == B_MAIN:
            _k3_equals_k2("cassie", spec, args)
            worst["cassie_substep"] = max(e3[n] for n in names)
            worst["cassie_substep_multi"] = max(e2[n] for n in names)
            worst["cassie_substep_multi_sensors"] = max(max(e2[n] for n in names),
                                                        es["bufs_scaled"])

    # a whole env step: 10 substeps in one launch against 10 launches of
    # one, and with a sensor update after each substep
    args = _cassie_inputs(eng, gen, B_MAIN)
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B_MAIN), args[0], args[1]))
    eps = torch.cat([suite.sample_eps(gen, B_MAIN) for _ in range(10)], 1)
    sw = dict(sensors=sens, bufs=bufs, eps=eps)
    k2 = substep_batched_multi(spec, 10, *args)
    ks = substep_batched_multi(spec, 10, *args, **sw)
    q, v, cmd, lam, wrench = args
    for _ in range(10):
        chained = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = chained[:3]
    p32 = substep_multi_reference(spec, 10, *args, **sw)
    p64 = substep_multi_reference(spec64, 10, *(x.double() for x in args), sensors=sens64,
                                  bufs=bufs.double(), eps=eps.double())
    torch.cuda.synchronize()
    carried = all(torch.equal(k2[i], chained[i]) for i in range(7))
    same = all(torch.equal(ks[i], k2[i]) for i in range(7))
    report = {f"K2 {n}": _gate_dist_vs_f64("", k2[i], p32[i], p64[i], check=False)
              for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))}
    print(f"[phase 1] cassie n_sub=10 B={B_MAIN}: K2 equal to 10 chained K2 launches at n_sub=1: "
          f"{carried}; K2 with sensors' physics equal to K2's: {same}; vs the f64 plain version "
          "(reported): " + json.dumps(report))
    if not (carried and same):
        raise AssertionError(f"cassie n_sub=10: K2 not the chained single substeps ({carried}) or "
                             f"the sensor variant's physics not K2's ({same})")

    # one randomized K2 launch on the Cassie spec (the rows and springs are shared)
    args = _cassie_inputs(eng, gen, B_MAIN)
    mp, mpn = _rand_params(eng, gen, B_MAIN), _rand_params(eng, gen, B_MAIN, nominal=True)
    before = _counts()["rand_substep_multi"]
    kr = substep_batched_multi(spec, 1, *args, mp=mp)
    nominal = _nominal_gap(substep_batched_multi(spec, 1, *args, mp=mpn),
                           substep_batched_multi(spec, 1, *args))
    launched = _counts()["rand_substep_multi"] - before
    pr = substep_multi_reference(spec, 1, *args, mp=mp)
    pr64 = substep_multi_reference(spec64, 1, *(x.double() for x in args), mp=mp.double())
    torch.cuda.synchronize()
    gates = _held("cassie randomized n_sub=1", {"K2 randomized": kr}, pr, pr64)
    print(f"[phase 1] cassie randomized K2 n_sub=1 B={B_MAIN} ({launched + 1} launches with the "
          f"nominal run): nominal parameters vs the unrandomized K2 {nominal:.3g}; vs the f64 "
          "plain version: " + json.dumps(gates))
    if launched != 2 or nominal > NOMINAL_TOL:
        raise AssertionError(f"cassie randomized K2: {launched} launches, nominal gap {nominal}")

    # the loop tied to the world: one distance row, no contacts, well posed
    toy = _world_loop_toy(dev)
    tspec = toy.substep_spec
    kw = dict(generator=gen, device=dev)
    tq = 0.4 * torch.rand(B_MAIN, 2, **kw) - 0.2 + 0.6
    tv, ttau = torch.randn(B_MAIN, 2, **kw), 5.0 * torch.randn(B_MAIN, 2, **kw)
    tlam, tw = 0.1 * torch.randn(B_MAIN, 1, **kw), torch.zeros(B_MAIN, 6, device=dev)
    before = _counts()["substep"]
    kt = substep_batched(tspec, tq, tv, ttau, tlam, tw)
    rt = substep_reference(tspec, tq, tv, ttau, tlam, tw)
    torch.cuda.synchronize()
    et = {n: _max_err(a, b) for n, a, b in zip(names, kt, rt)}
    loaded = float((rt[2].abs() > 1e-3).double().mean())
    print(f"[phase 1] world-anchored loop (nv 2, nc 1, no contact) K3 B={B_MAIN}: "
          f"{json.dumps(et)}; share of envs whose row carries load {loaded:.3f}")
    if _counts()["substep"] - before != 1 or not all(e <= TOL for e in et.values()) \
            or loaded < 0.5:
        raise AssertionError(f"world-anchored loop: K3 disagrees with its plain version {et} "
                             f"(row loaded in {loaded} of the envs)")
    return worst


# ---- collision pairs and sphere sites (A.13 with B.7): the slice is
# CassieEnv(sim_dt=2e-3, target_speed=0.4, self_collision=True)
# (examples/train.py --env cassie --self-collision, cassie_selfcol_run5)
CASSIE_SELFCOL_KW = dict(CASSIE_KW, observe="state", self_collision=True)
CASSIE_SELFCOL_SENSOR_KW = dict(CASSIE_SENSOR_KW, self_collision=True)
CASSIE_SELFCOL_PUSH_KW = dict(CASSIE_PUSH_KW, self_collision=True)
ACTIVE_SHARE = 0.25  # the least share of envs with an active pair row in the pair gates
SPHERE_RADIUS = 0.02  # ANYmal's foot sites as spheres


def _pair_sets():
    """Pair sets on Cassie's tree: ``seg``, the slice's three leg capsule
    pairs; ``ptbox``, a box on the pelvis against the L thigh capsule (5
    axis points, nc 43); ``ptseg``, a 6-point convex cloud on the R tarsus
    against the L tarsus capsule (nc 46)."""
    from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair, ConvexMesh
    from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs

    def leg(body):
        return Capsule(body, (0.0, 0.0, 0.0), (0.0, 0.0, -0.35), 0.04)

    cloud = ((0.06, 0.0, -0.17), (-0.06, 0.0, -0.17), (0.0, 0.08, -0.17), (0.0, -0.08, -0.17),
             (0.0, 0.0, -0.05), (0.0, 0.0, -0.29))
    return {
        "seg": cassie_self_collision_pairs(),
        "ptbox": (CollisionPair(Box("pelvis", (0.0, 0.0, -0.15), (0.06, 0.08, 0.08)),
                                leg("L_thigh")),),
        "ptseg": (CollisionPair(ConvexMesh("R_tarsus", cloud), leg("L_tarsus"), friction=0.6),),
    }


def _selfcol_inputs(engine, gen, B, flexibility=False):
    """`_cassie_inputs` with the legs brought together: the hip rolls
    inward (L −U(0, 0.4), R U(0, 0.4) rad, up to the limits) and the hip
    yaws U(−0.3, 0.3) rad."""
    q, v, cmd, lam0, wrench = _cassie_inputs(engine, gen, B, flexibility)
    t, kw = engine.tree, dict(generator=gen, device=q.device)
    j = [t.q_off[t.joint_index(n)] for n in ("L_hip_roll", "R_hip_roll", "L_hip_yaw", "R_hip_yaw")]
    q[:, j[0]] = -0.4 * torch.rand(B, **kw)
    q[:, j[1]] = 0.4 * torch.rand(B, **kw)
    q[:, j[2:]] = 0.6 * torch.rand(B, 2, **kw) - 0.3
    return q, v, cmd, lam0, wrench


def _active_pair_envs(engine, q) -> torch.Tensor:
    """(B,) bool: the envs with a pair row active (depth > −margin) at q."""
    from jiminy_tpu_torch.core import algos
    from jiminy_tpu_torch.engine.collision import pair_rows

    spec, o = engine.substep_spec, engine.options
    xw = algos.forward_kinematics(spec.tree, q)
    act = pair_rows(spec.pairs, spec.tree, xw, spec.dt, spec.alpha_c_over_dt, o.contact_margin,
                    o.contact_slop, o.contact_max_correction_vel)[2]
    return (act > 0).any(dim=1)


def _active_pair_share(engine, q) -> float:
    """Share of envs with a pair row active at q."""
    return float(_active_pair_envs(engine, q).double().mean())


def phase_pairs_vs_plain(dev) -> dict:
    """The kernels with collision pairs (`jt_pair_item`) against their plain
    versions on Cassie's tree, each pair set of `_pair_sets` from
    `_selfcol_inputs`, at B = 4096 and n_sub = 1:

    - K3 and K2: q, v, λ (the pair rows included) and the impulses held to
      the float64 plain version by their distribution (`_gate_dist_vs_f64`,
      Cassie's float32 being ill posed), with at least a quarter of the
      envs having an active pair row (the share printed); one launch each;
    - the slice's pairs (seg): K2 with the sensor stage's physics bit-equal
      to K2's, and K2 over a whole env step (n_sub = 10) bit-equal to ten
      chained launches of one substep (λ of the pair rows carried).

    Returns each kernel's worst |kernel − plain f32|."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    names = ("q", "v", "lam", "residual", "impulse")
    gen = torch.Generator(device=dev).manual_seed(51)
    worst = {}
    for kind, pairs in _pair_sets().items():
        eng = _cassie_engine(dev, pairs=pairs)
        spec = eng.substep_spec
        spec64 = _cassie_engine(dev, torch.float64, pairs=pairs).substep_spec
        args = _selfcol_inputs(eng, gen, B_MAIN)
        q, v, cmd, lam0, wrench = args
        share = _active_pair_share(eng, q)
        tau = eng._joint_torque(cmd, q, v)
        before = _counts()
        k3 = substep_batched(spec, q, v, tau, lam0, wrench)
        k2 = substep_batched_multi(spec, 1, *args)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        r3 = substep_reference(spec, q, v, tau, lam0, wrench)
        r2 = substep_multi_reference(spec, 1, *args)
        a64 = [x.double() for x in args]
        r3_64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4])
        r2_64 = substep_multi_reference(spec64, 1, *a64)
        torch.cuda.synchronize()
        e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
        e2 = {n: _max_err(a, b) for n, a, b in zip(names, k2, r2)}
        pushed = float((r3[2][:, spec.pair_off:] != 0).any(1).double().mean())
        gates = {}
        for kname, k, p32, p64 in (("K3", k3, r3, r3_64), ("K2", k2, r2, r2_64)):
            for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
                gates[f"{kname} {n}"] = _gate_dist_vs_f64(f"pairs {kind} {kname} {n}", k[i],
                                                          p32[i], p64[i])
        print(f"[phase 1] pairs {kind} on cassie (nc {spec.nc}, {spec.n_pc} pair contacts, "
              f"colors {list(spec.cfg.contact_colors)}) B={B_MAIN}: share of envs with an active "
              f"pair row {share:.4f}, with a pair row's λ nonzero {pushed:.4f}; max |kernel − "
              f"plain f32|: K3 {json.dumps(e3)}; K2 n_sub=1 {json.dumps(e2)}; launches "
              f"{json.dumps(launched)}; vs the f64 plain version: " + json.dumps(gates))
        if share < ACTIVE_SHARE:
            raise AssertionError(f"pairs {kind}: only {share} of the envs have an active pair row")
        if launched != {"substep": 1, "substep_multi": 1}:
            raise AssertionError(f"pairs {kind}: unexpected launches {launched}")
        _k3_equals_k2(f"pairs {kind} on cassie", spec, args)
        worst[f"pairs_{kind}"] = max(max(e3[n] for n in names), max(e2[n] for n in names))

    # the slice's pairs: the sensor variant's physics, and a whole env step
    eng = _cassie_engine(dev, pairs=_pair_sets()["seg"])
    spec = eng.substep_spec
    suite = _cassie_model(dev)[2]
    args = _selfcol_inputs(eng, gen, B_MAIN)
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B_MAIN), args[0], args[1]))
    k2 = substep_batched_multi(spec, 1, *args)
    ks = substep_batched_multi(spec, 1, *args, sensors=SensorKernelSpec(eng.tree, suite, 1),
                               bufs=bufs, eps=suite.sample_eps(gen, B_MAIN))
    sens_same = all(torch.equal(ks[i], k2[i]) for i in range(7))
    whole = substep_batched_multi(spec, 10, *args)
    q, v, cmd, lam, wrench = args
    for _ in range(10):
        chained = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = chained[:3]
    torch.cuda.synchronize()
    carried = all(torch.equal(whole[i], chained[i]) for i in range(7))
    print(f"[phase 1] pairs seg on cassie B={B_MAIN}: K2 with sensors' physics equal to K2's: "
          f"{sens_same}; K2 at n_sub=10 equal to 10 chained K2 launches at n_sub=1: {carried}")
    if not (sens_same and carried):
        raise AssertionError(f"pairs seg: the sensor variant's physics not K2's ({sens_same}) or "
                             f"K2 not the chained single substeps ({carried})")
    return worst


def _sphere_model(dev):
    """ANYmal's tree with its four foot sites as spheres of SPHERE_RADIUS,
    rebuilt from the tree's arrays, and its motors and stand pose."""
    import numpy as np

    from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
    from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

    tree, motors, _ = make_anymal(device=dev)
    d = {k: getattr(tree, k) for k in STATIC_FIELDS + ARRAY_FIELDS}
    d = {k: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for k, x in d.items()}
    d["contact_radius"] = np.full(tree.ncp, SPHERE_RADIUS, np.float32)
    return tree_from_arrays(d, device=dev), motors, stand_q(tree)


def _sphere_engine(dev, dtype=torch.float32, ground=None, fusion=True):
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController

    tree, motors, _ = _sphere_model(dev)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8, substep_fusion=fusion,
                         constraint_solver="substep")
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(80.0, 2.0), ground=ground, device=dev)


def phase_spheres_vs_plain(dev) -> dict:
    """K3 and K2 (n_sub = 1, B = 4096) with sphere contact sites (ANYmal's
    feet of radius SPHERE_RADIUS: the site offset before the contact
    Jacobians) on flat ground and on a Fourier ground per env (the
    two-pass query), held env by env to the float64 plain version
    (`_gate_vs_f64`, as the ANYmal ground kernels). Returns each kernel's
    worst |kernel − plain f32|."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    names = ("q", "v", "lam", "residual", "impulse")
    gen = torch.Generator(device=dev).manual_seed(61)
    worst = {}
    for kind in ("flat", "fourier"):
        template = _ground_template(kind, dev) if kind != "flat" else None
        eng = _sphere_engine(dev, ground=template)
        spec = eng.substep_spec
        spec64 = _sphere_engine(dev, torch.float64, ground=template).substep_spec
        if kind == "flat":
            args, gc = _substep_inputs(eng, gen, B_MAIN), None
        else:
            args, gc, _ = _ground_inputs(eng, kind, gen, B_MAIN)
        q, v, cmd, lam0, wrench = args
        tau = eng._joint_torque(cmd, q, v)
        k3 = substep_batched(spec, q, v, tau, lam0, wrench, gc=gc)
        k2 = substep_batched_multi(spec, 1, *args, gc=gc)
        r3 = substep_reference(spec, q, v, tau, lam0, wrench, gc=gc)
        r2 = substep_multi_reference(spec, 1, *args, gc=gc)
        a64 = [x.double() for x in args]
        g64 = gc.double() if gc is not None else None
        r3_64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4], gc=g64)
        r2_64 = substep_multi_reference(spec64, 1, *a64, gc=g64)
        torch.cuda.synchronize()
        e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
        e2 = {n: _max_err(a, b) for n, a, b in zip(names, k2, r2)}
        loaded = float((r3[4][..., 2] != 0).any(1).double().mean())
        gates = {}
        for kname, k, p32, p64 in (("K3", k3, r3, r3_64), ("K2", k2, r2, r2_64)):
            for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
                gates[f"{kname} {n}"] = _gate_vs_f64(f"spheres {kind} {kname} {n}", k[i], p32[i],
                                                     p64[i])
        print(f"[phase 1] sphere sites (r {SPHERE_RADIUS}) on {kind} ground B={B_MAIN}: share of "
              f"envs with a loaded foot {loaded:.4f}; max |kernel − plain f32|: K3 "
              f"{json.dumps(e3)}; K2 n_sub=1 {json.dumps(e2)}; vs the f64 plain version: "
              + json.dumps(gates))
        if loaded < 0.5:
            raise AssertionError(f"sphere sites on {kind} ground: {loaded} of the envs loaded")
        _k3_equals_k2(f"sphere sites on {kind} ground", spec, args, gc=gc)
        worst[f"spheres_{kind}"] = max(max(e3[n] for n in names), max(e2[n] for n in names))
    return worst


# ---- spherical flexibility (A.14 with B.8): the slice is
# CassieEnv(sim_dt=2e-3, target_speed=0.4, flexibility=True)
# (examples/train.py --env cassie_flex, cassie_flex_run5): a SPHERICAL
# joint of 600 N·m/rad above each hip roll, nb 17, nv 26, nq 29, nc 28
CASSIE_FLEX_KW = dict(CASSIE_KW, observe="state", flexibility=True)
CASSIE_FLEX_SENSOR_KW = dict(CASSIE_SENSOR_KW, flexibility=True)
CASSIE_FLEX_PUSH_KW = dict(CASSIE_PUSH_KW, flexibility=True)
FLEX_ANGLE = 0.5  # rad, the largest hip deflection of the phase-1 inputs


def _flex_quats(engine, q, gen):
    """Set each flexibility joint's quaternion in ``q`` (B, nq), in place:
    a rotation of U(0, FLEX_ANGLE) rad about a uniform axis, negated
    (w < 0) in a quarter of the envs, the exact identity in an eighth and a
    rotation of 1e-8–1e-7 rad in another eighth (both `jt_quat_log`'s
    small-angle branch). Returns the share of env-joints on each branch."""
    B, dev = q.shape[0], q.device
    kw = dict(generator=gen, device=dev)
    e = B // 8
    for qo in engine.tree.sprung_spherical[1]:
        axis = torch.randn(B, 3, **kw)
        axis = axis / axis.norm(dim=1, keepdim=True)
        angle = FLEX_ANGLE * torch.rand(B, **kw)
        angle[e:2 * e] = 1e-8 + 9e-8 * torch.rand(e, **kw)
        half = 0.5 * angle[:, None]
        quat = torch.cat([axis * torch.sin(half), torch.cos(half)], 1)
        quat[:e] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        quat[torch.rand(B, **kw) < 0.25] *= -1.0
        q[:, qo:qo + 4] = quat
    quats = torch.stack([q[:, o:o + 4] for o in engine.tree.sprung_spherical[1]]).reshape(-1, 4)
    small = (quats[:, :3].double() ** 2).sum(1) < 1e-14
    return {"w<0": float((quats[:, 3] < 0).double().mean()),
            "small_angle": float(small.double().mean()),
            "large_angle": float((~small).double().mean())}


def _flex_inputs(engine, gen, B):
    """`_cassie_inputs` on the flexible-hip model with the hips deflected
    (`_flex_quats`; the rollouts' deflections are small at 600 N·m/rad,
    these reach every branch of the spring's log) → (the inputs, the
    branch shares)."""
    args = _cassie_inputs(engine, gen, B, flexibility=True)
    return args, _flex_quats(engine, args[0], gen)


def phase_flex_vs_plain(dev) -> dict:
    """The kernels on the flexible-hip Cassie spec (B.8: the SPHERICAL
    joints' columns, FK, RNEA bias, quaternion integrate and the springs'
    −k·log(quat)) against their plain versions from `_flex_inputs`, at
    B = 4096:

    - K3, K2 and K2 with the sensor stage (the pelvis and both hip IMUs,
      below the flexibility joints; the 10 encoders) at n_sub = 1: τ within
      1e-4 of its size, the sensor variant's q, v, λ, impulses, a and τ
      bit-equal to K2's, and q, v, λ, the impulses and the scaled buffers
      held to the float64 plain version by `_gate_dist_vs_f64`; a nonzero
      share of the env-joints on each branch of `jt_quat_log` (w < 0,
      small angle, large angle);
    - K2 over a whole env step (n_sub = 10) bit-equal to ten chained K2
      launches, and K2 with the sensor stage's physics bit-equal to it;
    - flexibility with the self-collision pairs (nc 37), K3 and K2 at
      n_sub = 1 from `_selfcol_inputs` with the hips deflected, held the
      same way, a quarter of the envs at least with an active pair row.

    Returns each kernel's worst |kernel − plain f32|."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    eng, eng64 = _cassie_engine(dev, flexibility=True), _cassie_engine(dev, torch.float64,
                                                                        flexibility=True)
    spec, spec64 = eng.substep_spec, eng64.substep_spec
    suite = _cassie_model(dev, True)[2]
    sens = SensorKernelSpec(eng.tree, suite, 1)
    sens64 = SensorKernelSpec(eng64.tree, suite.to(dtype=torch.float64), 1)
    names = ("q", "v", "lam", "residual", "impulse")
    gen = torch.Generator(device=dev).manual_seed(61)
    args, branches = _flex_inputs(eng, gen, B_MAIN)
    q, v, cmd, lam0, wrench = args
    tau = eng._joint_torque(cmd, q, v)
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B_MAIN), q, v))
    sw = dict(sensors=sens, bufs=bufs, eps=suite.sample_eps(gen, B_MAIN))
    before = _counts()
    k3 = substep_batched(spec, q, v, tau, lam0, wrench)
    k2 = substep_batched_multi(spec, 1, *args)
    ks = substep_batched_multi(spec, 1, *args, **sw)
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    r3 = substep_reference(spec, q, v, tau, lam0, wrench)
    r2 = substep_multi_reference(spec, 1, *args, **sw)
    a64 = [x.double() for x in args]
    r3_64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4])
    r2_64 = substep_multi_reference(spec64, 1, *a64, sensors=sens64, bufs=bufs.double(),
                                    eps=sw["eps"].double())
    torch.cuda.synchronize()
    e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
    e2 = {n: _max_err(a, b) for n, a, b in zip(names + ("a", "tau"), k2, r2)}
    scale = _reading_scale(sens, r2_64[7])
    es = {"bufs_scaled": ((ks[7].double() - r2[7].double()).abs() / scale).max().item()}
    same = all(torch.equal(ks[i], k2[i]) for i in range(7))
    rows = {"pushrod": float((r3[2][:, :2] != 0).any(1).double().mean()),
            "bound": float((r3[2][:, 2:16] != 0).any(1).double().mean()),
            "contact": float((r3[2][:, 16:] != 0).any(1).double().mean())}
    vo = spec.tree.sprung_spherical[0]
    flex_tau = max(r2[6][:, o:o + 3].abs().max().item() for o in vo)
    print(f"[phase 1] cassie flex B={B_MAIN}: share of the hip flexibility joints on each "
          f"branch of jt_quat_log {json.dumps(branches)}; largest |τ| on a flexibility dof "
          f"{flex_tau:.4g} N·m; share of envs with a pushrod / bound / contact row's λ nonzero "
          f"{json.dumps(rows)}; max |kernel − plain f32|: K3 {json.dumps(e3)}; K2 n_sub=1 "
          f"{json.dumps(e2)}; K2 with sensors {json.dumps(es)}, physics equal to the sensor-free "
          f"K2: {same}; launches {json.dumps(launched)}")
    gates = _held("cassie flex n_sub=1", {"K3": k3}, r3, r3_64)
    gates.update(_held("cassie flex n_sub=1", {"K2": k2, "K2 sensors": ks}, r2, r2_64, scale))
    print("[phase 1] cassie flex n_sub=1 vs the f64 plain version: " + json.dumps(gates))
    tau_scale = max(1.0, r2[6].abs().max().item())
    if not (e2["tau"] <= TOL * tau_scale and same):
        raise AssertionError(f"cassie flex: K2's τ off by {e2['tau']} or the sensor variant's "
                             f"physics not the sensor-free K2's ({same})")
    if launched != {"substep": 1, "substep_multi": 1, "substep_multi_sensors": 1}:
        raise AssertionError(f"cassie flex: unexpected launches {launched}")
    if min(branches.values()) <= 0.0 or rows["pushrod"] < 0.5 or rows["bound"] < 0.1:
        raise AssertionError(f"cassie flex inputs miss a branch of the log {branches} or engage "
                             f"too few pushrod or bound rows {rows}")
    _k3_equals_k2("cassie flex", spec, args)
    worst = {"cassie_flex_substep": max(e3[n] for n in names),
             "cassie_flex_substep_multi": max(e2[n] for n in names),
             "cassie_flex_substep_multi_sensors": max(max(e2[n] for n in names),
                                                      es["bufs_scaled"])}

    # a whole env step in one launch against ten launches of one substep
    eps10 = torch.cat([suite.sample_eps(gen, B_MAIN) for _ in range(10)], 1)
    k2 = substep_batched_multi(spec, 10, *args)
    ks = substep_batched_multi(spec, 10, *args, sensors=sens, bufs=bufs, eps=eps10)
    q, v, cmd, lam, wrench = args
    for _ in range(10):
        chained = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = chained[:3]
    torch.cuda.synchronize()
    carried = all(torch.equal(k2[i], chained[i]) for i in range(7))
    same = all(torch.equal(ks[i], k2[i]) for i in range(7))
    print(f"[phase 1] cassie flex n_sub=10 B={B_MAIN}: K2 equal to 10 chained K2 launches at "
          f"n_sub=1: {carried}; K2 with sensors' physics equal to K2's: {same}")
    if not (carried and same):
        raise AssertionError(f"cassie flex n_sub=10: K2 not the chained single substeps "
                             f"({carried}) or the sensor variant's physics not K2's ({same})")

    # flexibility with the self-collision pairs, at n_sub = 1
    pairs = _pair_sets()["seg"]
    peng = _cassie_engine(dev, pairs=pairs, flexibility=True)
    pspec = peng.substep_spec
    pspec64 = _cassie_engine(dev, torch.float64, pairs=pairs, flexibility=True).substep_spec
    pargs = _selfcol_inputs(peng, gen, B_MAIN, flexibility=True)
    pbranches = _flex_quats(peng, pargs[0], gen)
    q, v, cmd, lam0, wrench = pargs
    share = _active_pair_share(peng, q)
    tau = peng._joint_torque(cmd, q, v)
    before = _counts()
    k3 = substep_batched(pspec, q, v, tau, lam0, wrench)
    k2 = substep_batched_multi(pspec, 1, *pargs)
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    r3 = substep_reference(pspec, q, v, tau, lam0, wrench)
    r2 = substep_multi_reference(pspec, 1, *pargs)
    a64 = [x.double() for x in pargs]
    r3_64 = substep_reference(pspec64, a64[0], a64[1], tau.double(), a64[3], a64[4])
    r2_64 = substep_multi_reference(pspec64, 1, *a64)
    torch.cuda.synchronize()
    e3 = {n: _max_err(a, b) for n, a, b in zip(names, k3, r3)}
    e2 = {n: _max_err(a, b) for n, a, b in zip(names, k2, r2)}
    gates = _held("cassie flex self-collision n_sub=1", {"K3": k3}, r3, r3_64)
    gates.update(_held("cassie flex self-collision n_sub=1", {"K2": k2}, r2, r2_64))
    print(f"[phase 1] cassie flex with self-collision (nc {pspec.nc}) B={B_MAIN}: branches "
          f"{json.dumps(pbranches)}; share of envs with an active pair row {share:.4f}; max "
          f"|kernel − plain f32|: K3 {json.dumps(e3)}; K2 n_sub=1 {json.dumps(e2)}; launches "
          f"{json.dumps(launched)}; vs the f64 plain version: " + json.dumps(gates))
    if share < ACTIVE_SHARE or launched != {"substep": 1, "substep_multi": 1}:
        raise AssertionError(f"cassie flex self-collision: active pair share {share}, "
                             f"launches {launched}")
    _k3_equals_k2("cassie flex with self-collision", pspec, pargs)
    return worst


# ---- B.10 (PRISMATIC joints, A.15): the reference's PRISMATIC kernel
# scene (tests/test_box_pairs.py `test_box_pair_kernel_matches_xla`), a
# twin of it whose slider is oblique, and the cartpole

SLAB_DT, SLAB_ITERS, SLAB_SUBSTEPS = 1e-3, 8, 6  # tests/test_box_pairs.py:201-225
OBLIQUE_AXIS = (0.6, 0.0, 0.8)  # the twin's slider: both halves and two axis components
CARTPOLE_SUBSTEPS = 20  # a 20 ms env step at EngineOptions' default 1 ms
CART_LIMIT = 2.4  # make_cartpole()'s x_limit, m


@functools.cache
def _slab_model(dev, axis=(0.0, 0.0, 1.0)):
    """(tree, motors, pairs) of tests/test_box_pairs.py's
    `_slab_and_free_body` with its ptbox pair (friction 0.8): a stiff-sprung
    PRISMATIC slab along ``axis`` (100 kg, stiffness 1e7, damping 1e4) and a
    FREE 1 kg cube; nb 2, nq 8, nv 7, 16 pair contacts, nc 48 (the large
    frame). A direct motor on the slider without friction: a zero command
    is the reference test's zero torque, and the torque path is
    declarative, so ``Engine.step`` is one K2 launch."""
    import numpy as np

    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine.collision import Box, CollisionPair
    from jiminy_tpu_torch.hardware.motors import Motors

    b = TreeBuilder()
    b.add_body("slab", -1, JointType.PRISMATIC, axis=axis, mass=100.0, com=(0, 0, 0.05),
               inertia=np.diag([10.0] * 3), joint_name="slab_z", stiffness=1e7, damping=1e4)
    b.add_body("cube", -1, JointType.FREE, mass=1.0, inertia=np.diag([0.004] * 3),
               joint_name="cube_root")
    pair = CollisionPair(Box("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                         Box("cube", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8)
    return b.build(device=dev), Motors.create([0], names=["slab_z"], device=dev), (pair,)


def _slab_engine(dev, dtype=torch.float32, axis=(0.0, 0.0, 1.0), fusion=True,
                 solver="substep"):
    """The slab scene's engine (1 ms, 8 sweeps, the residual), float64 on
    the float32 model's constants."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions

    tree, motors, pairs = _slab_model(dev, axis)
    opts = EngineOptions(contact_model="constraint", dt=SLAB_DT, pgs_iters=SLAB_ITERS,
                         substep_fusion=fusion, constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  collision_pairs=pairs, device=dev)


def _slab_inputs(engine, gen, B):
    """States around the reference test's landing (`tests/test_box_pairs.py:211-223`:
    the cube at z 0.203 over the slab's face at 0.1, lateral speed (−0.3,
    0.2) scaled 0.5–1.5): the cube at z 0.197–0.207 (its face 3 mm in to 7
    mm above, the margin 5 mm), xy ±0.1 m, tilted up to ~0.06 rad, falling
    at 0–0.3 m/s and turning at ~0.5 rad/s; the slab 1e-4 m ± 1e-4 m below
    its spring's rest (its sag under the two bodies' weight) at ~0.01 m/s;
    λ0 ≥ 0, a motor command of ±50 N, a root (slab) wrench of ~5 N·m and
    ~20 N."""
    dev, t = engine.device, engine.tree
    kw = dict(generator=gen, device=dev)
    q = torch.zeros(B, t.nq, device=dev)
    q[:, 0] = -1e-4 + 2e-4 * torch.rand(B, **kw) - 1e-4
    q[:, 1:3] = 0.2 * torch.rand(B, 2, **kw) - 0.1
    q[:, 3] = 0.197 + 0.01 * torch.rand(B, **kw)
    quat = torch.cat([0.06 * torch.rand(B, 3, **kw) - 0.03, torch.ones(B, 1, device=dev)], 1)
    q[:, 4:8] = quat / quat.norm(dim=1, keepdim=True)
    scale = 0.5 + torch.rand(B, **kw)
    v = torch.zeros(B, t.nv, device=dev)
    v[:, 0] = 0.01 * torch.randn(B, **kw)
    v[:, 1], v[:, 2] = -0.3 * scale, 0.2 * scale
    v[:, 3] = -0.3 * torch.rand(B, **kw)
    v[:, 4:7] = 0.5 * torch.randn(B, 3, **kw)
    cmd = 100.0 * torch.rand(B, 1, **kw) - 50.0
    lam0 = (0.05 * torch.randn(B, engine.nc, **kw)).abs()
    wrench = torch.cat([5.0 * torch.randn(B, 3, **kw), 20.0 * torch.randn(B, 3, **kw)], 1)
    return q, v, cmd, lam0, wrench


def _cartpole_engine(dev, dtype=torch.float32, fusion=True, solver="substep"):
    """``make_cartpole()`` under ``EngineOptions(contact_model="constraint")``
    (1 ms, 16 sweeps, the residual): the cart's ±2.4 m limits one PGS
    bound row (nc 1), a direct motor on the slider (effort 30, the
    reference CartPoleEnv's force), so that the step is one K2 launch."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.hardware.motors import Motors
    from jiminy_tpu_torch.models.toys import make_cartpole

    opts = EngineOptions(contact_model="constraint", substep_fusion=fusion,
                         constraint_solver=solver)
    motors = Motors.create([0], names=["slider"], effort_limit=30.0, device=dev)
    return Engine(make_cartpole(device=dev, dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  device=dev)


def _cartpole_inputs(engine, gen, B):
    """Cartpole states: the cart over ±2.6 m, in a third of the envs
    within 2 mm of a limit (either side) moving outward at 0.5–2.5 m/s, so
    that the bound row binds; the pole ±0.5 rad at ~1 rad/s; λ0 ≥ 0; a
    command of ±40 N (past the effort limit in a quarter of the envs)."""
    dev = engine.device
    kw = dict(generator=gen, device=dev)
    q = torch.cat([5.2 * torch.rand(B, 1, **kw) - 2.6, torch.rand(B, 1, **kw) - 0.5], 1)
    v = torch.randn(B, 2, **kw)
    n = B // 3
    side = torch.where(torch.rand(n, **kw) < 0.5, -1.0, 1.0)
    q[:n, 0] = side * (CART_LIMIT + 0.004 * torch.rand(n, **kw) - 0.002)
    v[:n, 0] = side * (0.5 + 2.0 * torch.rand(n, **kw))
    cmd = 80.0 * torch.rand(B, 1, **kw) - 40.0
    lam0 = (0.05 * torch.randn(B, engine.nc, **kw)).abs()
    return q, v, cmd, lam0, torch.zeros(B, 6, device=dev)


def _prismatic_case(dev, name, gen):
    """(engine, float64 engine, inputs, the n_sub of a step, the inputs'
    shares) of the B.10 case ``name``: "slab", "oblique" or "cartpole"."""
    if name == "cartpole":
        eng, eng64 = _cartpole_engine(dev), _cartpole_engine(dev, torch.float64)
        args = _cartpole_inputs(eng, gen, B_MAIN)
        return eng, eng64, args, CARTPOLE_SUBSTEPS, {}
    axis = OBLIQUE_AXIS if name == "oblique" else (0.0, 0.0, 1.0)
    eng, eng64 = _slab_engine(dev, axis=axis), _slab_engine(dev, torch.float64, axis=axis)
    args = _slab_inputs(eng, gen, B_MAIN)
    spring = (1e7 * args[0][:, 0]).abs()
    shares = {"active_pair_row": _active_pair_share(eng, args[0]),
              "slider_spring_force_mean_N": spring.mean().item()}
    return eng, eng64, args, SLAB_SUBSTEPS, shares


def phase_prismatic_vs_plain(dev, names) -> dict:
    """The PRISMATIC branches (B.10) in K3 and K2, nominal and randomized,
    against their plain versions on each case of ``names`` at B = 4096:
    K3, K2 at n_sub = 1 and K2 over a step's substeps (6 on the slab
    scenes, 20 on the cartpole), nominal, and K3 and K2 at n_sub = 1 with
    each env's model parameters (`_rand_params`), each held env by env
    against the float64 plain version by `_gate_vs_f64` on q, v and λ. The
    shares of envs with an active pair row (the slab scenes) and with the
    slider's bound row binding (its λ nonzero, the cartpole) are printed
    and a quarter is asked of each. Returns each kernel's worst |kernel −
    plain f32| per case."""
    from jiminy_tpu_torch.ops.substep_kernel import (
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
        unpack_model_params,
    )

    worst = {}
    for name in names:
        gen = torch.Generator(device=dev).manual_seed(70 + len(worst))
        eng, eng64, args, n_step, shares = _prismatic_case(dev, name, gen)
        spec, spec64 = eng.substep_spec, eng64.substep_spec
        q, v, cmd, lam0, wrench = args
        a64 = [x.double() for x in args]
        mp = _rand_params(eng, gen, B_MAIN)
        gates, errs = {}, {}
        before = _counts()
        for rand in (False, True):
            m, m64, pre = (mp, mp.double(), "rand ") if rand else (None, None, "")
            tau = eng._joint_torque(cmd, q, v, unpack_model_params(spec, m)[1] if rand else None)
            runs = {pre + "K3": (
                substep_batched(spec, q, v, tau, lam0, wrench, mp=m),
                substep_reference(spec, q, v, tau, lam0, wrench, mp=m),
                substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4], mp=m64))}
            for n in ((1,) if rand else (1, n_step)):
                runs[f"{pre}K2 n_sub={n}"] = (
                    substep_batched_multi(spec, n, *args, mp=m),
                    substep_multi_reference(spec, n, *args, mp=m),
                    substep_multi_reference(spec64, n, *a64, mp=m64))
            for kname, (k, p32, p64) in runs.items():
                errs[kname] = max(_max_err(k[i], p32[i]) for i in range(3))
                gates[kname] = {f: _gate_vs_f64(f"{name} {kname} {f}", k[i], p32[i], p64[i])
                                for i, f in ((0, "q"), (1, "v"), (2, "lam"))}
            if not rand and name == "cartpole":
                shares["bound_row_binding"] = float((runs["K3"][2][2][:, 0] != 0).double().mean())
                shares["at_or_past_limit"] = float((q[:, 0].abs() >= CART_LIMIT - 0.01)
                                                   .double().mean())
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        print(f"[phase 1] B.10 {name} (nb {spec.tree.nb}, nv {spec.tree.nv}, nc {spec.nc}, "
              f"axis {spec.tree.axis[0].tolist()}) B={B_MAIN}: shares {json.dumps(shares)}; max "
              f"|kernel − plain f32| {json.dumps(errs)}; launches {json.dumps(launched)}; vs the "
              f"f64 plain version: " + json.dumps(gates))
        share = shares.get("bound_row_binding", shares.get("active_pair_row"))
        if share < 0.25:
            raise AssertionError(f"B.10 {name}: the inputs engage the rows in too few envs {shares}")
        if launched != {"substep": 1, "substep_multi": 2, "rand_substep": 1,
                        "rand_substep_multi": 1}:
            raise AssertionError(f"B.10 {name}: unexpected launches {launched}")
        _k3_equals_k2(f"B.10 {name}", spec, args)
        _k3_equals_k2(f"B.10 {name} randomized", spec, args, mp=mp)
        stem = "cartpole" if name == "cartpole" else f"prismatic_{name}"
        worst[f"{stem}_substep"] = max(errs["K3"], errs["rand K3"])
        worst[f"{stem}_substep_multi"] = max(errs["K2 n_sub=1"], errs[f"K2 n_sub={n_step}"],
                                             errs["rand K2 n_sub=1"])
    return worst


def _prismatic_path(dev, name, steps, fusion=True):
    """``steps`` engine steps of the B.10 case ``name`` at B = 4096
    through ``Engine.step`` (6 substeps of 1 ms on the slab scene, 20 on
    the cartpole with its motor pushing outward at the limit) from fresh
    inputs, the counts set to 0 just before and read just after. Returns
    (the launches, the last state, the engine)."""
    gen = torch.Generator(device=dev).manual_seed(80)
    if name == "cartpole":
        eng, n_sub = _cartpole_engine(dev, fusion=fusion), CARTPOLE_SUBSTEPS
        q, v, cmd, _, _ = _cartpole_inputs(eng, gen, B_MAIN)
        cmd = 30.0 * torch.sign(q[:, :1])  # full force toward the nearer limit
    else:
        eng, n_sub = _slab_engine(dev, fusion=fusion), SLAB_SUBSTEPS
        q, v, _, _, _ = _slab_inputs(eng, gen, B_MAIN)
        cmd = torch.zeros(B_MAIN, 1, device=dev)  # the reference test's zero torque
    sim = eng.reset(q, v)
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(steps):
        sim = eng.step(sim, cmd, n_substeps=n_sub)
    torch.cuda.synchronize()
    got = _counts()
    _check_warp(f"B.10 {name} engine path", eng.substep_spec, got)
    if not (bool(torch.isfinite(sim.q).all()) and bool(torch.isfinite(sim.v).all())):
        raise AssertionError(f"non-finite state on the B.10 {name} path")
    return got, sim, eng


# ---- the Atlas humanoid (A.23): AtlasEnv at the reference's defaults (20 ms
# env steps of 5 substeps of 4 ms, PD kp 300, kd 15; examples/train.py --env
# atlas asks target_speed=0.3), nc 47; with its self-collision pairs (two
# leg capsule pairs, each lower arm against the torso box: 12 pair contacts,
# atlas_selfcol_run5) nc 83, the largest frame of the kernels (nc ≤ 96)
ATLAS_KW = dict(observe="state", target_speed=0.3)
ATLAS_SENSOR_KW = dict(ATLAS_KW, observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                       encoder_noise=0.005)
ATLAS_SUBSTEPS = 5


@functools.cache
def _atlas_model(dev):
    """(tree, motors, suite) of the humanoid with atlas_sensors_run's suite
    (4 ms period, 4 ms delay, noise 0.02 / 0.005)."""
    from jiminy_tpu_torch.models.humanoid import make_atlas

    return make_atlas(device=dev, sensor_period=4e-3, sensor_delay=0.004, imu_noise=0.02,
                      encoder_noise=0.005)


def _atlas_engine(dev, dtype=torch.float32, residual=True, fusion=True, solver="substep",
                  pairs=False):
    """AtlasEnv's engine (PD kp 300, kd 15, 4 ms, 8 sweeps), with its
    self-collision pairs with ``pairs``; in float64 on the float32 model's
    constants."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.humanoid import atlas_self_collision_pairs

    tree, motors, _ = _atlas_model(dev)
    opts = EngineOptions(contact_model="constraint", dt=4e-3, pgs_iters=8,
                         compute_solver_residual=residual, substep_fusion=fusion,
                         constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(300.0, 15.0),
                  collision_pairs=atlas_self_collision_pairs() if pairs else (), device=dev)


def _atlas_inputs(engine, gen, B):
    """Atlas states around the stand pose: the motor joints ±0.05 rad; in
    a quarter of the envs both knees within 1 cm·rad of their lower limit
    (either side of it, so that the bounds rows bind); in half of them the
    legs rolled inward (hip rolls 0.05–0.3 rad) and the shoulders turned
    in (0.2–0.5 rad), the legs' and the lower arms' pair rows active; the
    base 1 cm low to 0.5 cm high (the sole corners penetrating, hovering
    within the margin and clear) and tilted, v ~ 0.3·N(0, 1), λ0 ≥ 0, PD
    targets ±0.1 rad around the joints, a root wrench of ~5 N·m and ~20
    N."""
    from jiminy_tpu_torch.models.humanoid import atlas_stand_q

    t, dev = engine.tree, engine.device
    kw = dict(generator=gen, device=dev)
    qi = list(engine.motors.q_idx)
    q = torch.as_tensor(atlas_stand_q(t), device=dev).repeat(B, 1)
    q[:, qi] += 0.1 * torch.rand(B, len(qi), **kw) - 0.05

    def j(name):
        return t.q_off[t.joint_index(name)]

    knees = [j("l_leg_kny"), j("r_leg_kny")]
    q[:B // 4, knees] = 0.02 * torch.rand(B // 4, 2, **kw) - 0.01
    h = B // 2
    q[h:, j("l_leg_hpx")] = -0.05 - 0.25 * torch.rand(B - h, **kw)
    q[h:, j("r_leg_hpx")] = 0.05 + 0.25 * torch.rand(B - h, **kw)
    q[h:, j("l_arm_shx")] = -0.2 - 0.3 * torch.rand(B - h, **kw)
    q[h:, j("r_arm_shx")] = 0.2 + 0.3 * torch.rand(B - h, **kw)
    q[:, 2] += 0.015 * torch.rand(B, **kw) - 0.01
    quat = torch.cat([0.06 * torch.rand(B, 3, **kw) - 0.03, torch.ones(B, 1, device=dev)], 1)
    q[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    v = 0.3 * torch.randn(B, t.nv, **kw)
    lam0 = (0.05 * torch.randn(B, engine.nc, **kw)).abs()
    cmd = q[:, qi] + 0.2 * torch.rand(B, len(qi), **kw) - 0.1
    wrench = torch.cat([5.0 * torch.randn(B, 3, **kw), 20.0 * torch.randn(B, 3, **kw)], 1)
    return q, v, cmd, lam0, wrench


def _atlas_sensor_inputs(engine, gen, q, v, n_upd):
    """K2's sensor keywords at the states (q, v): the suite's kernel spec
    (an update every substep), ring buffers of distinct slots (the reset
    fill plus noise) and the corruption of ``n_upd`` updates."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    suite, B = _atlas_model(engine.device)[2], q.shape[0]
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
    bufs = bufs + 0.1 * torch.randn(bufs.shape, generator=gen, device=bufs.device)
    eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_upd)], 1)
    return dict(sensors=SensorKernelSpec(engine.tree, suite, 1), bufs=bufs, eps=eps)


def phase_atlas_vs_plain(dev) -> dict:
    """The kernels on the Atlas spec (nb 24, nv 29, 5 substeps of 4 ms),
    without its pairs (nc 47) and with them (nc 83, six PGS colors), from
    `_atlas_inputs` at B = 4096:

    - the condition of M over the inputs (float64), printed, and the plain
      float32 version's own distance to float64 (in the gates): they decide
      the gate. Atlas's armature (0.15 on every joint) keeps κ(M) in
      ANYmal's regime (~258), not Cassie's (~2.7e4), so without the pairs
      one float32 substep is well posed and each kernel is held env by env
      against the float64 plain version (`_gate_vs_f64`). With the pairs it
      is not: each lower arm meets the torso box at 5 points along one
      segment, 5 nearly dependent rows in one color, a Delassus block
      close to singular, so one float32 substep of the plain version sits
      ~1e-2 from float64 in v in a sizeable share of the envs (the gates
      print the plain version's own distance); the kernels are then held by
      the distribution of the per-env distance (`_gate_dist_vs_f64`), as
      on Cassie;
    - K3, K2 at n_sub = 1 and K2 with the sensor stage at n_sub = 1 (the
      IMU, 23 encoders and 23 efforts) on q, v, λ (the pair rows included)
      and the impulses, and the sensor K2's buffers scaled by reading
      (`_reading_scale`), held to float64 by that gate beside the float32
      plain version (the largest |kernel − plain f32| printed); with the
      pairs at least a quarter of the envs with an active pair row (the
      share printed); one launch each;
    - K2 over the env step's 5 substeps against float64, by the
      distribution (float32 compounds over the substeps), held without the
      pairs and reported with them;
    - the bit-identities: K3 given K2's applied τ equal to K2 at n_sub = 1
      (`_k3_equals_k2`), K2 at n_sub = 5 equal to 5 chained launches of
      one, the sensor K2's physics (n_sub = 5, five updates) equal to K2's;
    - K1 at the pairs' configuration (n 29, nc 83, 8 sweeps) on random SPD
      systems (`_rand_system`) within 1e-4 of ``solve_reference``, a second
      launch bit-equal.

    Returns each kernel's worst |kernel − plain f32| (K2 at n_sub = 1)."""
    from jiminy_tpu_torch.core import algos
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference
    from jiminy_tpu_torch.ops.substep_kernel import (
        SensorKernelSpec,
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    names = ("q", "v", "lam", "residual", "impulse")
    gen = torch.Generator(device=dev).manual_seed(90)
    worst = {}
    for pairs in (False, True):
        label = "atlas self-collision" if pairs else "atlas"
        key = "atlas_selfcol" if pairs else "atlas"
        eng = _atlas_engine(dev, pairs=pairs)
        spec = eng.substep_spec
        spec64 = _atlas_engine(dev, torch.float64, pairs=pairs).substep_spec
        args = _atlas_inputs(eng, gen, B_MAIN)
        q, v, cmd, lam0, wrench = args
        if not pairs:
            t64 = spec64.tree
            M = algos.crba(t64, q.double()) + torch.diag_embed(t64.armature.expand(B_MAIN, -1))
            kappa = torch.linalg.cond(M)
            qs = torch.quantile(kappa, torch.tensor([0.5, 0.99], dtype=kappa.dtype, device=dev))
            print(f"[phase 1] atlas: condition of M (f64, armature included) over the inputs: "
                  f"p50 {qs[0].item():.1f}, p99 {qs[1].item():.1f}, max {kappa.max().item():.1f}")
        share = _active_pair_share(eng, q) if pairs else 0.0
        sw = _atlas_sensor_inputs(eng, gen, q, v, 1)
        sens = sw["sensors"]
        tau = eng._joint_torque(cmd, q, v)
        before = _counts()
        k3 = substep_batched(spec, q, v, tau, lam0, wrench)
        k2 = substep_batched_multi(spec, 1, *args)
        ks = substep_batched_multi(spec, 1, *args, **sw)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        r3 = substep_reference(spec, q, v, tau, lam0, wrench)
        r2 = substep_multi_reference(spec, 1, *args)
        rs = substep_multi_reference(spec, 1, *args, **sw)
        a64 = [x.double() for x in args]
        sw64 = dict(sensors=SensorKernelSpec(spec64.tree, sens.suite.to(dtype=torch.float64), 1),
                    bufs=sw["bufs"].double(), eps=sw["eps"].double())
        r3_64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4])
        r2_64 = substep_multi_reference(spec64, 1, *a64)
        rs_64 = substep_multi_reference(spec64, 1, *a64, **sw64)
        torch.cuda.synchronize()
        errs = {kname: {n: _max_err(a, b) for n, a, b in zip(names, k, r)}
                for kname, k, r in (("K3", k3, r3), ("K2", k2, r2), ("K2 sensors", ks, rs))}
        scale = _reading_scale(sens, rs_64[7])
        errs["K2 sensors"]["bufs_scaled"] = ((ks[7].double() - rs[7].double()).abs()
                                             / scale).max().item()
        gate = _gate_dist_vs_f64 if pairs else _gate_vs_f64
        gates = {}
        for kname, k, p32, p64 in (("K3", k3, r3, r3_64), ("K2", k2, r2, r2_64),
                                   ("K2 sensors", ks, rs, rs_64)):
            for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
                gates[f"{kname} {n}"] = gate(f"{label} {kname} {n}", k[i], p32[i], p64[i])
        gates["K2 sensors bufs_scaled"] = gate(
            f"{label} K2 sensors bufs", ks[7].double() / scale, rs[7].double() / scale,
            rs_64[7] / scale)
        pushed = (float((r3[2][:, spec.pair_off:] != 0).any(1).double().mean())
                  if pairs else 0.0)
        print(f"[phase 1] {label} (nb {spec.tree.nb}, nv {spec.tree.nv}, nc {spec.nc}, "
              f"{spec.n_pc} pair contacts, colors {list(spec.cfg.contact_colors)}) B={B_MAIN}: "
              f"share of envs with an active pair row {share:.4f}, with a pair row's λ nonzero "
              f"{pushed:.4f}; max |kernel − plain f32| {json.dumps(errs)}; launches "
              f"{json.dumps(launched)}; vs the f64 plain version: " + json.dumps(gates))
        if launched != {"substep": 1, "substep_multi": 1, "substep_multi_sensors": 1}:
            raise AssertionError(f"{label}: unexpected launches {launched}")
        if pairs and share < ACTIVE_SHARE:
            raise AssertionError(f"{label}: only {share} of the envs have an active pair row")
        _k3_equals_k2(label, spec, args)
        worst[f"{key}_substep"] = max(errs["K3"].values())
        worst[f"{key}_substep_multi"] = max(errs["K2"].values())
        worst[f"{key}_substep_multi_sensors"] = max(errs["K2 sensors"].values())

        # a whole env step: K2 over 5 substeps held to float64; equal to 5
        # chained launches; the sensor variant's physics K2's
        n = ATLAS_SUBSTEPS
        sw5 = _atlas_sensor_inputs(eng, gen, q, v, n)
        k2n = substep_batched_multi(spec, n, *args)
        ksn = substep_batched_multi(spec, n, *args, **sw5)
        p32 = substep_multi_reference(spec, n, *args)
        p64 = substep_multi_reference(spec64, n, *a64)
        cq, cv, ccmd, clam, cw = args
        for _ in range(n):
            chained = substep_batched_multi(spec, 1, cq, cv, ccmd, clam, cw)
            cq, cv, clam = chained[:3]
        torch.cuda.synchronize()
        whole = {f"K2 n_sub={n} {f}": _gate_dist_vs_f64(f"{label} K2 n_sub={n} {f}", k2n[i],
                                                        p32[i], p64[i], check=not pairs)
                 for i, f in ((0, "q"), (1, "v"), (2, "lam"))}
        carried = all(torch.equal(k2n[i], chained[i]) for i in range(7))
        sens_same = all(torch.equal(ksn[i], k2n[i]) for i in range(7))
        # envs whose step ran away (|v| past 50 m/s), in each version: with
        # the pairs float64 runs away where float32 does (ROADMAP C.7)
        away = {name: int((out[1].abs().amax(dim=1) > 50.0).sum())
                for name, out in (("kernel", k2n), ("plain f32", p32), ("plain f64", p64))}
        print(f"[phase 1] {label} B={B_MAIN}: K2 at n_sub={n} vs the f64 plain version "
              f"{json.dumps(whole)}; envs with |v| > 50 m/s after the step {json.dumps(away)}; "
              f"equal to {n} chained K2 launches at n_sub=1: {carried}; K2 with the sensor "
              f"stage ({n} updates): physics equal to K2's: {sens_same}")
        if not (carried and sens_same):
            raise AssertionError(f"{label}: K2 not the chained single substeps ({carried}) or the "
                                 f"sensor variant's physics not K2's ({sens_same})")

    # K1 at the pairs' configuration
    cfg = dataclasses.replace(_atlas_engine(dev, pairs=True).substep_spec.cfg,
                              compute_residual=True)
    args = _rand_system(gen, B_MAIN, cfg.n, cfg.nc, dev)
    vk, lk, rk = solve_batched(cfg, *args, device=dev)
    vr, lr, rr = solve_reference(cfg, *args)
    again = solve_batched(cfg, *args, device=dev)
    torch.cuda.synchronize()
    errs = [_max_err(vk, vr), _max_err(lk, lr), _max_err(rk, rr)]
    same = all(torch.equal(a, b) for a, b in zip(again, (vk, lk, rk)))
    print(f"[phase 1] K1 at atlas self-collision's configuration (n {cfg.n}, nc {cfg.nc}, colors "
          f"{list(cfg.contact_colors)}, {cfg.iters} sweeps) B={B_MAIN}: max|dv|={errs[0]:.3g} "
          f"max|dlam|={errs[1]:.3g} max|dres|={errs[2]:.3g}; a second launch bit-equal: {same}")
    if not (all(e <= TOL for e in errs) and same):
        raise AssertionError(f"K1 at nc {cfg.nc}: {errs}, deterministic {same}")
    worst["atlas_selfcol_constraint_solve"] = max(errs)
    return worst


def phase_atlas_paths(dev, drive, drive_unfused, entry, path, act_gen) -> dict:
    """Phases 2 and 3 of the Atlas humanoid (A.23), with ``run``'s helpers:
    ``drive`` and ``drive_unfused`` (the counts set to 0 just before a
    path and read just after; ``path`` holds each path's launches),
    ``entry`` (a kernel's line in the kernels JSON):

    - phase 2: ``AtlasEnv(target_speed=0.3)`` (``examples/train.py --env
      atlas``) on the state and sensor paths, without and with its pairs,
      through ``"auto"``: 25 env steps each, exactly one K2 launch per step
      (with the sensor stage on the sensor paths) and no other, through the
      warp body; finite q, v, obs (B, 55) and reward. With the pairs also
      ``constraint_solver="kernel"`` (K1 at nc 83, 5 launches per step),
      ``substep_fusion=False`` (K3, 5 per step) and ``"inline"`` (the plain
      physics, no launch of ours; 2 steps);
    - phase 3: each path's env-steps/s (3 loops of 25 steps; 2 of 5 on
      ``"inline"``), the pairs' state path against ``"inline"`` in the same
      call; K2's warp body stage by stage on Atlas and on Atlas with its
      pairs (`tools/profile_warp_stages.py`); K2, K2 with the sensor stage
      (5 updates), K3 and K1 against their bounds and plain versions.

    Returns the paths' rates."""
    from jiminy_tpu_torch.envs import AtlasEnv
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference
    from jiminy_tpu_torch.ops.substep_kernel import (
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
    )

    atlas = {}  # label → (env, state)
    for label, akw, counter, seed in (
            ("atlas state path", ATLAS_KW, "substep_multi", 90),
            ("atlas sensor path", ATLAS_SENSOR_KW, "substep_multi_sensors", 91),
            ("atlas self-collision state path", dict(ATLAS_KW, self_collision=True),
             "substep_multi", 92),
            ("atlas self-collision sensor path", dict(ATLAS_SENSOR_KW, self_collision=True),
             "substep_multi_sensors", 93)):
        env_a = AtlasEnv(device=dev, **akw)
        a_spec = env_a.engine.substep_spec
        pairs = akw.get("self_collision", False)
        if env_a.engine.backend != "substep" or a_spec.nc != (83 if pairs else 47) \
                or env_a._fused_sensors != (akw["observe"] == "sensors"):
            raise AssertionError(f"{label}: 'auto' resolves to {env_a.engine.backend!r} at nc "
                                 f"{a_spec.nc}, not the whole-substep kernel's fused path")
        st = drive(label, env_a, seed, STEPS, **{counter: STEPS})
        ws = a_spec.warp_workspace()
        print(f"[phase 2] {label}: nb {a_spec.tree.nb}, nv {a_spec.tree.nv}, nc {a_spec.nc}, "
              f"colors {len(a_spec.cfg.contact_colors)}; obs {tuple(st.obs.shape)}; base height "
              f"mean {st.sim.q[:, 2].mean().item():.4f} m; share of envs with an active pair "
              f"row {_active_pair_share(env_a.engine, st.sim.q) if pairs else 0.0:.4f}; "
              f"{ws.bytes_per_env} B per env, W {ws.W}")
        if st.obs.shape != (B_MAIN, 55):
            raise AssertionError(f"{label}: obs of shape {tuple(st.obs.shape)}")
        atlas[label] = (env_a, st)
    env_ap, state_ap = atlas["atlas self-collision state path"]
    drive("atlas self-collision constraint_solver='kernel'",
          AtlasEnv(device=dev, constraint_solver="kernel", self_collision=True, **ATLAS_KW), 94,
          3, constraint_solve=3 * ATLAS_SUBSTEPS)
    eng_ak3 = _atlas_engine(dev, residual=False, fusion=False, pairs=True)
    drive_unfused("atlas self-collision substep_fusion=False", eng_ak3, walker=env_ap,
                  start=state_ap, substep=3 * ATLAS_SUBSTEPS)
    env_ai = AtlasEnv(device=dev, constraint_solver="inline", self_collision=True, **ATLAS_KW)
    state_ai = drive("atlas self-collision constraint_solver='inline'", env_ai, 95, 2)

    rates_a = {}
    for label, (env_a, st) in list(atlas.items()) + [
            ("atlas self-collision constraint_solver='inline'", (env_ai, state_ai))]:
        inline = "inline" in label
        steps = 5 if inline else STEPS
        for _ in range(2 if inline else 5):  # warm-up
            st = env_a.step(st, _uniform(act_gen, dev, 23))
        torch.cuda.synchronize()
        before = _counts()
        loops = 2 if inline else 3  # the host-paced plain path: 2 loops
        rates_a[label], st = _env_rate(env_a, st, act_gen, dev, steps, loops)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        print(f"[phase 3] env-steps/s at B={B_MAIN}, {label}: "
              f"{[round(r, 1) for r in rates_a[label]]} (max {max(rates_a[label]):.1f}); "
              f"launches in the {loops * steps} timed steps {json.dumps(launched)}")
        want = {} if inline else {("substep_multi_sensors" if "sensor" in label
                                   else "substep_multi"): loops * steps}
        if launched != want:
            raise AssertionError(f"{label}: {launched} in {loops * steps} timed env steps")
    fused_rate = max(rates_a["atlas self-collision state path"])
    inline_rate = max(rates_a["atlas self-collision constraint_solver='inline'"])
    print(f"[phase 3] atlas self-collision: the whole-substep kernel's state path at "
          f"{fused_rate / inline_rate:.2f}× the inline plain physics' rate (max against max)")
    from jiminy_tpu_torch.tools.profile_warp_stages import profile as stage_profile

    for sc in (False, True):
        for row in stage_profile(B_MAIN, dev, "atlas", self_collision=sc):
            print(f"[phase 3] K2 warp body stages, {row['model']} {row['path']} (n_sub "
                  f"{row['n_sub']}): share {json.dumps(row['share'])}; cycles per env per "
                  f"substep {json.dumps(row['cycles_per_env_substep'])}")

    # K2 over the env step's 5 substeps, with the sensor stage (5 updates),
    # without and with the pairs; K3 and K1 with the pairs (nc 83)
    agen = torch.Generator(device=dev).manual_seed(96)
    k2_src = "jiminy_tpu/ops/substep_kernel.py:1815"
    for pairs in (False, True):
        key = "atlas_selfcol" if pairs else "atlas"
        label = "atlas self-collision" if pairs else "atlas"
        aeng = _atlas_engine(dev, residual=False, fusion=False, pairs=pairs)
        aspec = aeng.substep_spec
        aargs = _atlas_inputs(aeng, agen, B_MAIN)
        asw = _atlas_sensor_inputs(aeng, agen, aargs[0], aargs[1], ATLAS_SUBSTEPS)
        a_ops = B_MAIN * (ATLAS_SUBSTEPS * (_substep_flops(aspec) + _torque_flops(aspec))
                          + 2 * aspec.tree.nv)
        print(f"[phase 3] {label}: {_substep_flops(aspec)} FLOP per env per substep (pairs "
              f"{_pair_flops(aspec)}, chain {_solve_flops(aspec.cfg)} at nv {aspec.tree.nv}, nc "
              f"{aspec.nc}), torque {_torque_flops(aspec)}, sensor update "
              f"{_sensor_flops(aspec, asw['sensors'])}")
        entry(
            f"{key}_substep_multi", WARP_SOURCE, k2_src,
            path[f"{label} state path"]["substep_multi"],
            _time_cuda(lambda: substep_batched_multi(aspec, ATLAS_SUBSTEPS, *aargs), 10),
            _time_cuda(lambda: substep_multi_reference(aspec, ATLAS_SUBSTEPS, *aargs), 2),
            _substep_multi_bytes(aspec, B_MAIN), a_ops,
        )
        entry(
            f"{key}_substep_multi_sensors", WARP_SOURCE, k2_src,
            path[f"{label} sensor path"]["substep_multi_sensors"],
            _time_cuda(lambda: substep_batched_multi(aspec, ATLAS_SUBSTEPS, *aargs, **asw), 10),
            _time_cuda(lambda: substep_multi_reference(aspec, ATLAS_SUBSTEPS, *aargs, **asw), 2),
            _substep_multi_bytes(aspec, B_MAIN) + _sensor_bytes(asw["sensors"], B_MAIN,
                                                                ATLAS_SUBSTEPS),
            a_ops + B_MAIN * ATLAS_SUBSTEPS * _sensor_flops(aspec, asw["sensors"]),
        )
        if pairs:
            aq, av, acmd, alam0, awrench = aargs
            atau = aeng._joint_torque(acmd, aq, av)
            entry(
                "atlas_selfcol_substep", WARP_SOURCE, "jiminy_tpu/ops/substep_kernel.py:1678",
                path["atlas self-collision substep_fusion=False"]["substep"],
                _time_cuda(lambda: substep_batched(aspec, aq, av, atau, alam0, awrench), 20),
                _time_cuda(lambda: substep_reference(aspec, aq, av, atau, alam0, awrench), 3),
                _substep_bytes(aspec, B_MAIN), B_MAIN * _substep_flops(aspec),
            )
            acfg = aspec.cfg
            k1_args = _rand_system(agen, B_MAIN, acfg.n, acfg.nc, dev)
            entry(
                "atlas_selfcol_constraint_solve", "jiminy_tpu_torch/csrc/constraint_solve.cu",
                "jiminy_tpu/ops/constraint_solve.py:358",
                path["atlas self-collision constraint_solver='kernel'"]["constraint_solve"],
                _time_cuda(lambda: solve_batched(acfg, *k1_args, device=dev), 20),
                _time_cuda(lambda: solve_reference(acfg, *k1_args), 3),
                _solve_bytes(acfg, B_MAIN), _solve_flops(acfg) * B_MAIN,
            )
    return rates_a


# ---- A.22 and A.24: the kinematic constraints, per-body wrenches and
# per-env friction, each on the plain substep around K1 (the reference's
# route for them)
GANTRY_KW = dict(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8)
SHANK_FORCE = 40.0  # N along the world y on each shank, scene (b)
FRICTION_RANGE = (0.2, 1.2)  # each env's ground friction, scene (b)
ROLL_RADIUS = 0.2  # tests/test_constraints.py's wheel; the ball alike
ROLL_SPIN = 5.0  # rad/s, rolling at v = ω·r
SLIP_BOUND = 1e-2  # m/s, tests/test_constraints.py's bound on the contact point's speed
# The kernel path's weld error against the plain float32 path's: at most
# 1.5x it, plus a slack of 1e-9 (rad or m), a quarter of the smaller
# reading on an H100 (4.4e-9 rad and 1.2e-8 m on either path), so that the
# ratio decides.
DRIFT_RATIO, DRIFT_SLACK = 1.5, 1e-9


def _roll_engine(dev, kind, dtype=torch.float32, solver="auto", ground=None):
    """tests/test_constraints.py's wheel (a free body, inertia diag(0.01,
    0.02, 0.01), 1 kg, its hub a frame at the origin) under a
    ``WheelConstraint`` of radius 0.2 about y, or a solid 1 kg ball of the
    same radius under a ``SphereConstraint``; no contact site (n 6, nc 3),
    1 ms substeps, 16 sweeps."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.constraints import SphereConstraint, WheelConstraint

    b = TreeBuilder()
    i_ball = 0.4 * ROLL_RADIUS ** 2
    inertia = (0.01, 0.02, 0.01) if kind == "wheel" else (i_ball, i_ball, i_ball)
    body = b.add_body(kind, parent=-1, joint_type=JointType.FREE, mass=1.0, inertia=inertia,
                      joint_name="root")
    b.add_frame("hub", body)
    c = (WheelConstraint(0, radius=ROLL_RADIUS) if kind == "wheel"
         else SphereConstraint(0, radius=ROLL_RADIUS))
    opts = EngineOptions(dt=1e-3, contact_model="constraint", constraint_solver=solver,
                         compute_solver_residual=False)
    return Engine(b.build(device=dev, dtype=dtype), opts, ground=ground, constraints=(c,),
                  device=dev)


def _roll_inputs(eng, gen, B, ground=None):
    """Upright wheels (or balls) on the ground at random xy in [−1, 1]²,
    the hub r above it, rolling along x at v = ω·r."""
    dev = eng.device
    q = torch.zeros(B, 7, device=dev)
    q[:, :2] = 2.0 * torch.rand(B, 2, generator=gen, device=dev) - 1.0
    q[:, 2] = ROLL_RADIUS + (0.0 if ground is None else ground.query(q[:, :2])[0])
    q[:, 6] = 1.0
    v = torch.zeros(B, 6, device=dev)
    v[:, 0], v[:, 4] = ROLL_SPIN * ROLL_RADIUS, ROLL_SPIN
    return q, v


def _contact_speed(sim):
    """(B,) speed of each wheel's lowest point (hub − r·e_z) on flat
    ground, and (B, 3) the hub's world velocity."""
    from jiminy_tpu_torch.math import so3

    R = so3.quat_to_matrix(sim.q[:, 3:7])
    v_w = (R @ sim.v[:, :3, None])[..., 0]
    w_w = (R @ sim.v[:, 3:6, None])[..., 0]
    down = torch.tensor([0.0, 0.0, -ROLL_RADIUS], device=sim.q.device).expand_as(w_w)
    return torch.linalg.vector_norm(v_w + so3.cross(w_w, down), dim=-1), v_w


def _shank_wrench(tree, B, dev):
    """Scene (b)'s (B, nb, 6) local wrenches: ``SHANK_FORCE`` along the
    local y of each shank, nothing elsewhere."""
    f = torch.zeros(B, tree.nb, 6, device=dev)
    for leg in ("LF", "RF", "LH", "RH"):
        f[:, tree.frame_body[tree.frame_index(f"{leg}_SHANK_frame")], 4] = SHANK_FORCE
    return f


def _weld_error(env, sim) -> dict:
    """The gantry's weld error over the envs, from its rows' target
    −(α/dt)·[log(R·R_refᵀ); p − p_ref]: the largest orientation (rad) and
    position (m) error."""
    from jiminy_tpu_torch.core import algos

    eng = env.engine
    weld = eng.constraints[0]
    _, t = weld.rows(eng.tree, sim.q, algos.forward_kinematics(eng.tree, sim.q),
                     eng.substep_spec.dt)
    err = t.double() / -weld.alpha_over_dt(eng.substep_spec.dt)
    return {"rot": torch.linalg.vector_norm(err[:, :3], dim=-1).max().item(),
            "pos": torch.linalg.vector_norm(err[:, 3:], dim=-1).max().item()}


def _gate_substeps(label, n_sub, k_step, p_step, p64_step, sim, u,
                   fields=("q", "v", "lam")) -> list:
    """``n_sub`` substeps from ``sim`` with the command ``u``, each feeding
    the kernel path ``k_step``, the plain float32 path ``p_step`` and the
    plain float64 path ``p64_step`` (each ``(sim, u) → sim``) the same
    inputs, held by `_gate_vs_f64` on ``fields`` (q, v and λ); the kernel
    path carries on. Returns the gates."""
    gates = []
    for i in range(n_sub):
        nk, np32 = k_step(sim, u), p_step(sim, u)
        sim64 = type(sim)(**{f: getattr(sim, f).double() for f in sim.FIELDS})
        n64 = p64_step(sim64, u.double())
        gates.append({f: _gate_vs_f64(f"{label} substep {i} {f}", getattr(nk, f),
                                      getattr(np32, f), getattr(n64, f))
                      for f in fields})
        sim = nk
    torch.cuda.synchronize()
    return gates


def _profiled_launches(fn, check: bool = False) -> dict:
    """GPU kernel launches of ``fn()`` under ``torch.profiler``: K1's
    (``solve_chain_warp``), the whole-substep kernels' (``substep``) and all.
    They are counted on the profiler's raw device events, in a fraction
    of the time its ``key_averages()`` takes on the 44k–50k-kernel windows
    of the continuous and K1 paths (``tools/probe_profiler.py``).
    ``check=True`` also counts them through ``key_averages()`` and raises
    unless the two agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def counts(ev):
        return {"k1": sum(c for k, c in ev if "solve_chain_warp" in k),
                "substep": sum(c for k, c in ev if "substep" in k),
                "all": sum(c for _, c in ev)}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    raw = counts([(e.name(), 1) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA])
    if check:
        averaged = counts([(e.key, e.count) for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA])
        if raw != averaged:
            raise AssertionError(f"the profiler's raw device events {raw} against its "
                                 f"key_averages {averaged}")
    return raw


def _check_profiled(label, prof, k1) -> None:
    """Fails unless the profiler recorded GPU kernels, ``k1`` of them K1's
    and none a whole-substep kernel's."""
    if not prof["all"]:
        raise AssertionError(f"{label}: torch.profiler recorded no GPU kernel")
    if prof["k1"] != k1 or prof["substep"]:
        raise AssertionError(f"{label} under the profiler: {prof}, expected {k1} K1 launches "
                             f"and no whole-substep kernel")


def phase_chain_paths(dev, drive, entry, main_err, path, act_gen) -> dict:
    """Phases 2 and 3 of the slice's three scenes (A.22, A.24), each
    through the entry points a user calls and on the chain kernel K1, as
    the reference routes them; with ``run``'s helpers (``drive``,
    ``entry``, ``path``):

    - (a) the gantry ANYmal, ``ANYmalGantryEnv(observe="state")``: the
      base welded 0.25 m above its stand pose, the LF knee locked; through
      ``"auto"`` (→ ``"kernel"``), nc 31: 4 K1 launches per env step and
      no other kernel of ours (counted by the wrappers and by
      ``torch.profiler``), 25 env steps;
    - (b) ANYmal's engine (``"substep"``) through ``Engine.step(...,
      fext_user=, contact_params=)``: a lateral force on each shank and
      each env's friction drawn from U(0.2, 1.2): 4 K1 launches per step,
      no K2 or K3 (counted by the wrappers and by ``torch.profiler``),
      25 steps;
    - (c) 4096 wheels (``WheelConstraint``) and 4096 balls
      (``SphereConstraint``) on a Fourier ground per env
      (``Engine.step(ground=)``), n 6, nc 3, 10 steps of 1 ms each;

    K1 against its plain chain at B = 4096 in the gantry's and the
    wheel's layouts (phase 1's tolerance); each scene's kernel path
    substep by substep against its plain float32 and float64 paths
    (`_gate_vs_f64`); the gantry's weld error after 25 steps within 1.5×
    the plain float32 path's (+1e-9) from the same inputs; rolling
    without slip on flat ground after 0.5 s (contact point < 1e-2 m/s);
    the scenes' env-steps/s on ``"auto"`` and ``"inline"`` beside ANYmal's
    K2 state path; K1's time and bound in each scene's layout. Returns the
    rates."""
    from jiminy_tpu_torch.engine.contact import ContactParams
    from jiminy_tpu_torch.engine.ground import sample_fourier_ground
    from jiminy_tpu_torch.envs import ANYmalEnv, ANYmalGantryEnv
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference

    cs = "constraint_solve"
    # ---- K1 in the scenes' layouts, against its plain chain; each scene's
    # engine is checked below to build exactly this layout
    held = {name: dataclasses.replace(_chain_configs()[name], iters=iters)
            for name, iters in (("gantry", 8), ("wheel", 16))}
    for name, cfg in held.items():
        gen = torch.Generator(device=dev).manual_seed(100)
        args = _rand_system(gen, B_MAIN, cfg.n, cfg.nc, dev)
        vk, lk, _ = solve_batched(cfg, *args, device=dev)
        vr, lr, _ = solve_reference(cfg, *args)
        err = max(_max_err(vk, vr), _max_err(lk, lr))
        print(f"[phase 1] K1 in the {name} layout (n {cfg.n}, nc {cfg.nc}, blocks "
              f"{[tuple(b)[1:] for b in cfg.eq_blocks]}) at B={B_MAIN}: max|Δ| {err:.3g}")
        if err > TOL:
            raise AssertionError(f"K1 disagrees with its plain chain in the {name} layout: {err}")
        main_err[f"{'gantry' if name == 'gantry' else 'rolling'}_{cs}"] = err

    # ---- (a) the gantry
    env_g = ANYmalGantryEnv(device=dev, **GANTRY_KW)
    spec_g = env_g.engine.substep_spec
    blocks = [tuple(b)[1:] for b in spec_g.cfg.eq_blocks]
    print(f"[phase 2] gantry: 'auto' → {env_g.engine.backend!r}, nc {spec_g.nc}, equality blocks "
          f"{blocks}, bounds {spec_g.cfg.bounds_span}, colors {spec_g.cfg.contact_colors}")
    if env_g.engine.backend != "kernel" or spec_g.cfg != held["gantry"]:
        raise AssertionError(f"the gantry does not resolve to the chain kernel in the layout "
                             f"K1 was held in: {env_g.engine.backend!r}, {spec_g.cfg}")
    st_g = drive("gantry path", env_g, 110, STEPS, constraint_solve=4 * STEPS)
    prof = _profiled_launches(lambda: [env_g.step(st_g, _uniform(act_gen, dev)) for _ in range(2)])
    print(f"[phase 2] gantry path, 2 env steps under torch.profiler: GPU kernel launches "
          f"{json.dumps(prof)} (K1 {prof['k1'] / 2:.0f} per env step, of "
          f"{prof['all'] / 2:.0f})")
    _check_profiled("gantry path", prof, k1=8)
    env_gi = ANYmalGantryEnv(device=dev, constraint_solver="inline", **GANTRY_KW)
    env_g64 = ANYmalGantryEnv(device=dev, constraint_solver="inline", dtype=torch.float64,
                              **GANTRY_KW)
    u_g = env_g._action_to_command(_uniform(act_gen, dev), st_g.sim)
    gates = _gate_substeps("gantry", env_g.n_substeps,
                           lambda s, u: env_g.engine.step(s, u),
                           lambda s, u: env_gi.engine.step(s, u),
                           lambda s, u: env_g64.engine.step(s, u), st_g.sim, u_g)
    print("[phase 2] gantry, one env step substep by substep, the kernel path vs the plain "
          "float32 and float64 paths on the same inputs: " + json.dumps(gates))
    # the weld's drift: 25 steps on each path from one reset, the same actions
    s_k = env_g.reset(torch.Generator(device=dev).manual_seed(111), B_MAIN)
    s_p = s_k
    for _ in range(STEPS):
        a = _uniform(act_gen, dev)
        s_k, s_p = env_g.step_no_reset(s_k, a), env_gi.step_no_reset(s_p, a)
    drift_k, drift_p = _weld_error(env_g, s_k.sim), _weld_error(env_gi, s_p.sim)
    print(f"[phase 2] gantry weld error after {STEPS} env steps from one reset (largest over "
          f"{B_MAIN} envs): kernel path {json.dumps(drift_k)}, plain float32 path "
          f"{json.dumps(drift_p)}")
    for k in ("rot", "pos"):
        if drift_k[k] > DRIFT_RATIO * drift_p[k] + DRIFT_SLACK:
            raise AssertionError(f"gantry weld drift {k}: kernel {drift_k[k]} against plain "
                                 f"{drift_p[k]}")
    _check_finite(s_k, "the gantry drift run")

    # ---- (b) per-body wrenches and per-env friction on ANYmal's engine
    env_b = ANYmalEnv(device=dev, **GANTRY_KW)
    eng_b = env_b.engine
    if eng_b.backend != "substep":
        raise AssertionError("ANYmal's engine is not on the whole-substep kernels")
    fgen = torch.Generator(device=dev).manual_seed(112)
    lo, hi = FRICTION_RANGE
    cp = ContactParams(friction=lo + (hi - lo) * torch.rand(B_MAIN, generator=fgen, device=dev))
    fext = _shank_wrench(eng_b.tree, B_MAIN, dev)
    extra = dict(fext_user=fext, contact_params=cp)
    st_b = env_b.reset(torch.Generator(device=dev).manual_seed(113), B_MAIN)
    sim_b = st_b.sim
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(STEPS):
        u = env_b._action_to_command(_uniform(act_gen, dev), sim_b)
        sim_b = eng_b.step(sim_b, u, n_substeps=env_b.n_substeps, **extra)
    torch.cuda.synchronize()
    label = "external forces and per-env friction"
    path[label] = got = _counts()
    warp = _check_warp(label, eng_b.substep_spec, got)
    print(f"[phase 2] {label} (ANYmal's engine, {SHANK_FORCE} N on each shank, friction "
          f"{cp.friction.min().item():.3f}–{cp.friction.max().item():.3f}), {STEPS} steps at "
          f"B={B_MAIN}: launches {json.dumps({n: c for n, c in got.items() if c})} (the warp "
          f"body {warp}); base y speed mean {sim_b.v[:, 1].mean().item():.4f} m/s")
    if got != _only(constraint_solve=4 * STEPS) or not bool(torch.isfinite(sim_b.v).all()):
        raise AssertionError(f"{label}: launches {got}")
    prof = _profiled_launches(lambda: [
        eng_b.step(sim_b, u, n_substeps=env_b.n_substeps, **extra) for _ in range(2)])
    print(f"[phase 2] {label}, 2 steps under torch.profiler: GPU kernel launches "
          f"{json.dumps(prof)}")
    _check_profiled(label, prof, k1=8)
    eng_bi = _anymal_engine(dev, residual=False, solver="inline")
    eng_b64 = _anymal_engine(dev, torch.float64, residual=False, solver="inline")
    extra64 = dict(fext_user=fext.double(),
                   contact_params=ContactParams(friction=cp.friction.double()))
    u_b = env_b._action_to_command(_uniform(act_gen, dev), sim_b)
    gates = _gate_substeps("external forces", env_b.n_substeps,
                           lambda s, u: eng_b.step(s, u, **extra),
                           lambda s, u: eng_bi.step(s, u, **extra),
                           lambda s, u: eng_b64.step(s, u, **extra64), sim_b, u_b)
    print(f"[phase 2] {label}, one env step substep by substep, the kernel path vs the plain "
          f"float32 and float64 paths: " + json.dumps(gates))

    # ---- (c) rolling: wheels and balls on a Fourier ground per env
    rgen = torch.Generator(device=dev).manual_seed(114)

    def fourier(batch_shape):
        return sample_fourier_ground(rgen, n_terms=16, amplitude=0.08, wavelength=1.5, octaves=3,
                                     batch_shape=batch_shape)

    roll_launches = 0
    for kind in ("wheel", "ball"):
        template = fourier(())
        eng_r = _roll_engine(dev, kind, ground=template)
        grounds = fourier((B_MAIN,))
        if eng_r.backend != "kernel" or eng_r.substep_spec.cfg != held["wheel"]:
            raise AssertionError(f"{kind}: 'auto' → {eng_r.backend!r} in the layout "
                                 f"{eng_r.substep_spec.cfg}")
        q, v = _roll_inputs(eng_r, rgen, B_MAIN, grounds)
        sim_r = eng_r.reset(q, v)
        zero = torch.zeros(B_MAIN, 6, device=dev)
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(10):
            sim_r = eng_r.step(sim_r, zero, ground=grounds)
        torch.cuda.synchronize()
        path[f"rolling {kind}s"] = got = _counts()
        _check_warp(f"rolling {kind}s", eng_r.substep_spec, got)
        h, _ = grounds.query(sim_r.q[:, :2])
        lift = (sim_r.q[:, 2] - h - ROLL_RADIUS).abs().max().item()
        print(f"[phase 2] rolling {kind}s on a Fourier ground per env, 10 steps of 1 ms at "
              f"B={B_MAIN}: launches {json.dumps({n: c for n, c in got.items() if c})}; |hub "
              f"height − ground height under it − r| {lift:.3g} m at worst (the contact point "
              f"lies along the normal)")
        if got != _only(constraint_solve=10) or not bool(torch.isfinite(sim_r.v).all()):
            raise AssertionError(f"rolling {kind}s: launches {got}")
        roll_launches += got[cs]
        eng_ri = _roll_engine(dev, kind, solver="inline", ground=template)
        eng_r64 = _roll_engine(dev, kind, torch.float64, solver="inline", ground=template)
        g64 = type(grounds)(grounds.gc.double())
        gates = _gate_substeps(f"rolling {kind}s", 2,
                               lambda s, u: eng_r.step(s, u, ground=grounds),
                               lambda s, u: eng_ri.step(s, u, ground=grounds),
                               lambda s, u: eng_r64.step(s, u, ground=g64), sim_r, zero)
        print(f"[phase 2] rolling {kind}s, two substeps, the kernel path vs the plain float32 "
              f"and float64 paths: " + json.dumps(gates))
    # rolling without slip on flat ground for 0.5 s
    eng_w = _roll_engine(dev, "wheel")
    sim_w = eng_w.reset(*_roll_inputs(eng_w, rgen, B_MAIN))
    torch.cuda.synchronize()
    _reset_counts()
    sim_w = eng_w.step(sim_w, torch.zeros(B_MAIN, 6, device=dev), n_substeps=500)
    torch.cuda.synchronize()
    got = _counts()
    slip, v_w = _contact_speed(sim_w)
    slip = slip.max().item()
    print(f"[phase 2] rolling wheels on flat ground, 0.5 s (500 substeps) at B={B_MAIN}: "
          f"launches {json.dumps({n: c for n, c in got.items() if c})}; contact-point speed "
          f"{slip:.3g} m/s at worst (bound {SLIP_BOUND}); world forward speed "
          f"{v_w[:, 0].min().item():.5f}–{v_w[:, 0].max().item():.5f} m/s (ω·r = "
          f"{ROLL_SPIN * ROLL_RADIUS})")
    if got != _only(constraint_solve=500) or not slip < SLIP_BOUND:
        raise AssertionError(f"rolling without slip: launches {got}, contact speed {slip}")

    # ---- phase 3: rates in this call, and K1's time in each layout
    rates = {}
    for _ in range(3):  # warm-up
        st_g = env_g.step(st_g, _uniform(act_gen, dev))
    before = _counts()
    rates["gantry, 'auto' (K1)"], st_g = _env_rate(env_g, st_g, act_gen, dev, STEPS, 2)
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    if launched != {cs: 4 * 2 * STEPS}:
        raise AssertionError(f"gantry path, timed: {launched}")
    st_gi = env_gi.reset(torch.Generator(device=dev).manual_seed(115), B_MAIN)
    st_gi = env_gi.step(st_gi, _uniform(act_gen, dev))  # warm-up
    before = _counts()
    rates["gantry, 'inline'"], _ = _env_rate(env_gi, st_gi, act_gen, dev, 5, 2)
    if _counts() != before:
        raise AssertionError("the inline gantry launched a kernel of ours")

    def engine_rate(eng, sim, kw, steps, loops):
        out = []
        for _ in range(loops):
            cmds = [env_b._action_to_command(_uniform(act_gen, dev), sim) for _ in range(steps)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for u in cmds:
                sim = eng.step(sim, u, n_substeps=env_b.n_substeps, **kw)
            torch.cuda.synchronize()
            out.append(B_MAIN * steps / (time.perf_counter() - t0))
        return out

    eng_b.step(sim_b, u_b, n_substeps=4, **extra)  # warm-up
    before = _counts()
    rates["external forces and friction, 'substep' (K1)"] = engine_rate(eng_b, sim_b, extra,
                                                                        STEPS, 2)
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    if launched != {cs: 4 * 2 * STEPS}:
        raise AssertionError(f"external forces path, timed: {launched}")
    eng_bi.step(sim_b, u_b, n_substeps=4, **extra)  # warm-up
    rates["external forces and friction, 'inline'"] = engine_rate(eng_bi, sim_b, extra, 5, 2)
    st_m = env_b.reset(torch.Generator(device=dev).manual_seed(116), B_MAIN)
    for _ in range(5):  # warm-up
        st_m = env_b.step(st_m, _uniform(act_gen, dev))
    rates["ANYmal state path (K2)"], _ = _env_rate(env_b, st_m, act_gen, dev, STEPS, 3)
    for k, r in rates.items():
        print(f"[phase 3] env-steps/s at B={B_MAIN}, {k}: {[round(x, 1) for x in r]} "
              f"(max {max(r):.1f})")
    k2 = max(rates["ANYmal state path (K2)"])
    r_a = max(rates["gantry, 'auto' (K1)"]) / k2
    r_b = max(rates["external forces and friction, 'substep' (K1)"]) / k2
    print(f"[phase 3] against ANYmal's K2 state path (max against max): the gantry's K1 path "
          f"{r_a:.4f}×, the external forces' {r_b:.4f}×")
    src = "jiminy_tpu_torch/csrc/constraint_solve.cu"
    k1_src = "jiminy_tpu/ops/constraint_solve.py:358"
    gcfg = spec_g.cfg
    for name, cfg, launches in (
            ("gantry", gcfg, path["gantry path"][cs]),
            ("fext_friction", eng_b.substep_spec.cfg, path[label][cs]),
            ("rolling", eng_w.substep_spec.cfg, roll_launches)):
        gen = torch.Generator(device=dev).manual_seed(117)
        args = _rand_system(gen, B_MAIN, cfg.n, cfg.nc, dev)
        if name == "fext_friction":
            main_err[f"{name}_{cs}"] = max(
                _max_err(a, b) for a, b in zip(solve_batched(cfg, *args, device=dev)[:2],
                                               solve_reference(cfg, *args)[:2]))
        print(f"[phase 3] K1 in the {name} layout: n {cfg.n}, nc {cfg.nc}, {cfg.iters} sweeps, "
              f"{_solve_flops(cfg)} FLOP per env")
        entry(f"{name}_{cs}", src, k1_src, launches,
              _time_cuda(lambda: solve_batched(cfg, *args, device=dev), 50),
              _time_cuda(lambda: solve_reference(cfg, *args), 5),
              _solve_bytes(cfg, B_MAIN), _solve_flops(cfg) * B_MAIN)
    return rates


# ---- A.16: the paths off the impulse engine. The reference's default
# penalty contacts run the continuous path (plain PyTorch, no kernel); its
# registered forces, penalty contacts beside constraints and bounds not run
# as constraints keep an impulse model on the plain substep around K1
PENALTY_OPTS = dict(dt=1e-3, compute_solver_residual=False)
STANCE_Z = (0.45, 0.6)  # tests/test_engine.py TestPenaltyFrictionStability, after 1 s
STANCE_STEPS = 50  # 1 s of 20 ms env steps
IMPULSE_FORCE = (0.0, 60.0, 0.0)  # N, world, on the base in [0.02, 0.07) s, scene (b)
CARTPOLE_PPO = dict(num_envs=256, rollout_len=32, minibatches=4, epochs=4, hidden=(64, 64))
# tests/test_ppo.py test_cartpole_improves runs 30; its gate holds at 15 (the
# series is deterministic from the seed: iterations 11–15 at 0.196 of 1–5)
CARTPOLE_ITERS = 15
GATE_ENVS = 1024  # the envs of the continuous paths' gates, whose plain float32 leg runs on the CPU


def _gantry_penalty_cfg():
    """K1's layout on the gantry with penalty contacts: the weld's 6 rows
    and the lock's 1, the 12 bound rows, no contact row (1 ms, 8 sweeps)."""
    from jiminy_tpu_torch.engine.solver import BlockSpec
    from jiminy_tpu_torch.ops.constraint_solve import SolveConfig

    return SolveConfig(n=18, nc=19, dt=1e-3,
                       eq_blocks=(BlockSpec("equality", 0, 6), BlockSpec("equality", 6, 1)),
                       bounds_span=(7, 12), contact_colors=(), iters=8, compute_residual=False)


def _sim_on(sim, dev, n=None):
    """``sim`` on ``dev``, its first ``n`` envs (all for None)."""
    return type(sim)(**{f: getattr(sim, f)[:n].to(dev) for f in sim.FIELDS})


def _profile_force(t):
    """Scene (b)'s profile force on the base: a 2 Hz lateral sway of 20 N
    and a 10 N lift."""
    return torch.stack([20.0 * torch.sin(4.0 * torch.pi * t), torch.zeros_like(t),
                        torch.full_like(t, 10.0)], dim=-1)


def _forces_engine(dev, dtype=torch.float32, solver="auto"):
    """ANYmal's impulse engine (5 ms, 8 sweeps, PD 80/2) with an impulse
    and a profile force on its base frame."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.engine.forces import ImpulseForce, ProfileForce
    from jiminy_tpu_torch.models.quadruped import make_anymal

    tree, motors, _ = make_anymal(device=dev)
    base = tree.frame_index("base_frame")
    forces = (ImpulseForce(base, 0.02, 0.05, torch.tensor(IMPULSE_FORCE, dtype=dtype, device=dev)),
              ProfileForce(base, _profile_force))
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         compute_solver_residual=False, constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(80.0, 2.0), forces=forces, device=dev)


def _toy_actions(env, gen, dev):
    """Each env's discrete action, uniform."""
    return torch.randint(0, env.discrete_actions, (B_MAIN,), generator=gen, device=dev)


def _toy_rate(env, state, gen, dev, steps, loops):
    rates = []
    for _ in range(loops):
        acts = [_toy_actions(env, gen, dev) for _ in range(steps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        rates.append(B_MAIN * steps / (time.perf_counter() - t0))
    return rates, state


def phase_penalty_paths(dev, drive, entry, main_err, path, act_gen) -> dict:
    """Phases 2 and 3 of the paths off the impulse engine (A.16), through
    the entry points a user calls, at B = 4096:

    - (a) ANYmal on the reference's default contact model,
      ``ANYmalEnv(observe="state", engine_options=EngineOptions(dt=1e-3,
      compute_solver_residual=False))``: penalty contacts and bounds,
      symplectic Euler, 20 substeps per env step, plain PyTorch: no launch
      of ours (the counters, and ``torch.profiler``: no K1, K2 or K3); the
      PD stance from the stand pose after 1 s (``Engine.step``) with the
      base between 0.45 and 0.6 m, the reference test's bound;
    - (b) ANYmal's impulse engine with an impulse and a profile force on
      its base frame through ``"auto"`` (→ ``"kernel"``): 4 K1 launches
      per env step and no K2 or K3 (the counters and the profiler);
    - (c) ``ANYmalGantryEnv`` on the default contact model (dt 1 ms, 8
      sweeps): the weld and lock rows and the 12 bound rows, the feet as
      penalty contacts, nc 19: 20 K1 launches per env step;
    - (d) ``CartPoleEnv`` and ``AcrobotEnv`` env steps (continuous, no
      launch of ours);

    each path's step substep by substep against its plain float32 and
    float64 paths on the card (for (a) and (d), whose path is the plain
    one, against the CPU's float32 run and the card's float64, on the
    first 1,024 envs; `_gate_vs_f64`); K1 against its plain chain in the nc 19 layout and
    timed against its bound (``gantry_penalty_constraint_solve``);
    env-steps/s and launches per env step (the profiler) of each path
    beside ANYmal's K2 state path; ``simulate_adaptive`` on the pendulum
    in float64 with the CPU's counters; and the reference's
    ``test_cartpole_improves`` (256 envs, 15 of its 30 iterations, hidden (64, 64)):
    the mean ``episode_done_frac`` of the last 5 iterations below half that
    of the first 5. Returns the rates and the readings."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, FlatGround
    from jiminy_tpu_torch.envs import AcrobotEnv, ANYmalEnv, ANYmalGantryEnv, CartPoleEnv
    from jiminy_tpu_torch.models.quadruped import stand_q
    from jiminy_tpu_torch.models.toys import make_pendulum
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference
    from jiminy_tpu_torch.rl import PPOConfig, make_train_fn

    cs = "constraint_solve"
    out = {"rates": {}, "launches_per_env_step": {}}
    rates, per_step = out["rates"], out["launches_per_env_step"]
    t_phase = time.perf_counter()

    # ---- K1 in the nc 19 layout, against its plain chain
    gcfg = _gantry_penalty_cfg()
    gen = torch.Generator(device=dev).manual_seed(120)
    k1_args = _rand_system(gen, B_MAIN, gcfg.n, gcfg.nc, dev)
    vk, lk, _ = solve_batched(gcfg, *k1_args, device=dev)
    vr, lr, _ = solve_reference(gcfg, *k1_args)
    err = max(_max_err(vk, vr), _max_err(lk, lr))
    print(f"[phase 1] K1 in the gantry-penalty layout (n 18, nc 19: blocks of 6 and 1, 12 "
          f"bounds, no contact row) at B={B_MAIN}: max|Δ| {err:.3g}")
    if err > TOL:
        raise AssertionError(f"K1 disagrees with its plain chain in the nc 19 layout: {err}")
    main_err[f"gantry_penalty_{cs}"] = err

    # ---- (a) ANYmal on penalty contacts: the continuous path
    kw_a = dict(observe="state", engine_options=EngineOptions(**PENALTY_OPTS))
    env_a = ANYmalEnv(device=dev, **kw_a)
    eng_a = env_a.engine
    if eng_a.impulse or eng_a.backend != "inline" or eng_a.nc or env_a.n_substeps != 20:
        raise AssertionError(f"penalty ANYmal: impulse {eng_a.impulse}, backend "
                             f"{eng_a.backend!r}, nc {eng_a.nc}, {env_a.n_substeps} substeps")
    st_a = drive("penalty path (continuous, no kernel)", env_a, 121, 2)
    # the reference test's stance: the PD holding the stand pose from rest, 1 s
    q0 = torch.as_tensor(stand_q(eng_a.tree), device=dev).repeat(B_MAIN, 1)
    sim = eng_a.reset(q0)
    u0 = env_a._stand_targets.expand(B_MAIN, -1)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(STANCE_STEPS):
        sim = eng_a.step(sim, u0, n_substeps=env_a.n_substeps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts()
    z = sim.q[:, 2]
    out["stance_z"] = [z.min().item(), z.max().item()]
    print(f"[phase 2] penalty stance (the PD at the stand pose, tests/test_engine.py's case), "
          f"{STANCE_STEPS} env steps = 1 s at B={B_MAIN} in {wall:.2f} s: base z "
          f"{out['stance_z'][0]:.5f}–{out['stance_z'][1]:.5f} m (bound {STANCE_Z}); launches "
          f"{json.dumps({n: c for n, c in got.items() if c})}")
    if got != _only() or not (STANCE_Z[0] < z.min().item() and z.max().item() < STANCE_Z[1]):
        raise AssertionError(f"penalty stance: launches {got}, base z {out['stance_z']}")
    rates["penalty stance, Engine.step"] = [B_MAIN * STANCE_STEPS / wall]
    prof = _profiled_launches(lambda: env_a.step(st_a, _uniform(act_gen, dev)))
    print(f"[phase 2] penalty path, 1 env step under torch.profiler: GPU kernel launches "
          f"{json.dumps(prof)}")
    _check_profiled("penalty path", prof, k1=0)
    per_step["penalty (a)"] = prof["all"]
    env_a_cpu = ANYmalEnv(device="cpu", **kw_a)
    env_a64 = ANYmalEnv(device=dev, dtype=torch.float64, **kw_a)

    def on_cpu(eng):
        return lambda s, u: _sim_on(eng.step(_sim_on(s, "cpu"), u.cpu()), dev)

    # the CPU leg on the first GATE_ENVS envs: its time grows with the batch
    u_a = env_a._action_to_command(_uniform(act_gen, dev), st_a.sim)[:GATE_ENVS]
    gates = _gate_substeps("penalty", env_a.n_substeps, lambda s, u: eng_a.step(s, u),
                           on_cpu(env_a_cpu.engine), lambda s, u: env_a64.engine.step(s, u),
                           _sim_on(st_a.sim, dev, GATE_ENVS), u_a, fields=("q", "v"))
    print(f"[phase 2] penalty path, one env step substep by substep on {GATE_ENVS} envs, the "
          "card's float32 vs the CPU's float32 and the card's float64: " + json.dumps(gates))
    rates["penalty (a), env.step"], _ = _env_rate(env_a, st_a, act_gen, dev, 2, 1)
    _lap("penalty paths (a): ANYmal on penalty contacts, the 1 s stance included")

    # ---- (b) registered forces on ANYmal's impulse engine: K1
    eng_b = _forces_engine(dev)
    if eng_b.backend != "kernel" or eng_b.nc != 24:
        raise AssertionError(f"registered forces: 'auto' → {eng_b.backend!r}, nc {eng_b.nc}")
    walker = ANYmalEnv(observe="state", device=dev)
    sim_b = walker.reset(torch.Generator(device=dev).manual_seed(122), B_MAIN).sim
    n_b = 10
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(n_b):
        sim_b = eng_b.step(sim_b, walker._action_to_command(_uniform(act_gen, dev), sim_b),
                           n_substeps=walker.n_substeps)
    torch.cuda.synchronize()
    label = "registered forces path"
    path[label] = got = _counts()
    warp = _check_warp(label, eng_b.substep_spec, got)
    print(f"[phase 2] {label} (an impulse of {IMPULSE_FORCE} N on the base in [0.02, 0.07) s and "
          f"a profile force), {n_b} steps of 4 substeps at B={B_MAIN}: launches "
          f"{json.dumps({n: c for n, c in got.items() if c})} (the warp body {warp}); base y "
          f"speed mean {sim_b.v[:, 1].mean().item():.4f} m/s")
    if got != _only(constraint_solve=4 * n_b) or not bool(torch.isfinite(sim_b.v).all()):
        raise AssertionError(f"{label}: launches {got}")
    u_b = walker._action_to_command(_uniform(act_gen, dev), sim_b)
    prof = _profiled_launches(lambda: eng_b.step(sim_b, u_b, n_substeps=4), check=True)
    print(f"[phase 2] {label}, 1 step under torch.profiler: GPU kernel launches "
          f"{json.dumps(prof)} (counted on the raw events and by key_averages alike)")
    _check_profiled(label, prof, k1=4)
    per_step["registered forces (b)"] = prof["all"]
    eng_bi, eng_b64 = _forces_engine(dev, solver="inline"), _forces_engine(dev, torch.float64,
                                                                          "inline")
    gates = _gate_substeps("registered forces", 4, lambda s, u: eng_b.step(s, u),
                           lambda s, u: eng_bi.step(s, u), lambda s, u: eng_b64.step(s, u),
                           sim_b, u_b)
    print(f"[phase 2] {label}, one step substep by substep, the kernel path vs the plain float32 "
          f"and float64 paths: " + json.dumps(gates))
    before = _counts()
    rb = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            sim_b = eng_b.step(sim_b, u_b, n_substeps=4)
        torch.cuda.synchronize()
        rb.append(B_MAIN * 3 / (time.perf_counter() - t0))
    rates["registered forces (b), 'auto' (K1)"] = rb
    if {n: c - before[n] for n, c in _counts().items() if c != before[n]} != {cs: 24}:
        raise AssertionError("registered forces path, timed: not 4 K1 launches per step")

    _lap("penalty paths (b): registered forces")
    # ---- (c) the gantry on penalty contacts: K1 at nc 19
    kw_c = dict(observe="state", engine_options=EngineOptions(pgs_iters=8, **PENALTY_OPTS))
    env_c = ANYmalGantryEnv(device=dev, **kw_c)
    spec_c = env_c.engine.substep_spec
    print(f"[phase 2] gantry on penalty contacts: 'auto' → {env_c.engine.backend!r}, nc "
          f"{spec_c.nc}, layout {spec_c.cfg}")
    if env_c.engine.backend != "kernel" or spec_c.cfg != gcfg or not spec_c.penalty:
        raise AssertionError(f"the penalty gantry is not on K1 in the nc 19 layout: {spec_c.cfg}")
    n_c = 3
    st_c = drive("gantry penalty path", env_c, 123, n_c, constraint_solve=20 * n_c)
    prof = _profiled_launches(lambda: env_c.step(st_c, _uniform(act_gen, dev)))
    print(f"[phase 2] gantry penalty path, 1 env step under torch.profiler: GPU kernel launches "
          f"{json.dumps(prof)}")
    _check_profiled("gantry penalty path", prof, k1=20)
    per_step["gantry penalty (c)"] = prof["all"]
    kw_ci = dict(kw_c, engine_options=dataclasses.replace(kw_c["engine_options"],
                                                          constraint_solver="inline"))
    env_ci = ANYmalGantryEnv(device=dev, **kw_ci)
    env_c64 = ANYmalGantryEnv(device=dev, dtype=torch.float64, **kw_ci)
    u_c = env_c._action_to_command(_uniform(act_gen, dev), st_c.sim)
    gates = _gate_substeps("gantry penalty", env_c.n_substeps,
                           lambda s, u: env_c.engine.step(s, u),
                           lambda s, u: env_ci.engine.step(s, u),
                           lambda s, u: env_c64.engine.step(s, u), st_c.sim, u_c)
    print("[phase 2] gantry penalty path, one env step substep by substep, the kernel path vs the "
          "plain float32 and float64 paths: " + json.dumps(gates))
    before = _counts()
    rates["gantry penalty (c), 'auto' (K1)"], st_c = _env_rate(env_c, st_c, act_gen, dev, 2, 2)
    if {n: c - before[n] for n, c in _counts().items() if c != before[n]} != {cs: 80}:
        raise AssertionError("gantry penalty path, timed: not 20 K1 launches per env step")

    _lap("penalty paths (c): the gantry on penalty contacts")
    # ---- (d) the toy envs
    tgen = torch.Generator(device=dev).manual_seed(124)
    for name, Env in (("cartpole", CartPoleEnv), ("acrobot", AcrobotEnv)):
        env_d, env_dc = Env(device=dev), Env(device="cpu")
        env_d64 = Env(device=dev, dtype=torch.float64)
        st_d = env_d.reset(torch.Generator(device=dev).manual_seed(125), B_MAIN)
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(5):
            st_d = env_d.step(st_d, _toy_actions(env_d, tgen, dev))
        torch.cuda.synchronize()
        path[f"{name} env"] = got = _counts()
        _check_finite(st_d, f"the {name} env")
        print(f"[phase 2] {name} env, 5 env steps at B={B_MAIN}: launches "
              f"{json.dumps({n: c for n, c in got.items() if c})}; done this step "
              f"{int(st_d.done.sum())}/{B_MAIN}")
        if got != _only():
            raise AssertionError(f"the {name} env launched a kernel of ours: {got}")
        a = _toy_actions(env_d, tgen, dev)
        prof = _profiled_launches(lambda: env_d.step(st_d, a))
        _check_profiled(f"{name} env", prof, k1=0)
        per_step[f"{name} (d)"] = prof["all"]
        u_d = env_d._action_to_command(a, st_d.sim)[:GATE_ENVS]
        gates = _gate_substeps(name, env_d.n_substeps, lambda s, u: env_d.engine.step(s, u),
                               on_cpu(env_dc.engine), lambda s, u: env_d64.engine.step(s, u),
                               _sim_on(st_d.sim, dev, GATE_ENVS), u_d, fields=("q", "v"))
        print(f"[phase 2] {name} env, one env step substep by substep on {GATE_ENVS} envs, the "
              f"card's float32 vs the CPU's float32 and the card's float64: " + json.dumps(gates))
        rates[f"{name} (d)"], _ = _toy_rate(env_d, st_d, tgen, dev, 3, 2)

    _lap("penalty paths (d): the cartpole and the acrobot")
    # ---- simulate_adaptive: one pendulum trajectory, float64, as on the CPU
    adaptive = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        eng_p = Engine(make_pendulum(device=where, dtype=torch.float64), EngineOptions(dt=1e-3),
                       ground=FlatGround(height=-100.0), device=where)  # the tip's out of reach
        st_p = eng_p.reset(torch.tensor([[1.2]], dtype=torch.float64, device=where))
        fin, adaptive[key] = eng_p.simulate_adaptive(st_p, 1.0)
        adaptive[key]["q"] = fin.q.item()
    print(f"[phase 2] simulate_adaptive, the pendulum from 1.2 rad for 1 s (float64): card "
          f"{json.dumps(adaptive['card'])}, CPU {json.dumps(adaptive['cpu'])}")
    counters = ("accepted", "rejected", "iters")
    if any(adaptive["card"][k] != adaptive["cpu"][k] for k in counters) \
            or abs(adaptive["card"]["q"] - adaptive["cpu"]["q"]) > 1e-9:
        raise AssertionError(f"simulate_adaptive on the card differs from the CPU: {adaptive}")
    out["adaptive"] = adaptive["card"]

    _lap("penalty paths: simulate_adaptive")
    # ---- the reference's test_cartpole_improves on the card
    env_t = CartPoleEnv(device=dev)
    init_fn, train_step, _ = make_train_fn(env_t, PPOConfig(**CARTPOLE_PPO))
    carry = init_fn(0, CARTPOLE_PPO["num_envs"])
    done = []
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(CARTPOLE_ITERS):
        carry, m = train_step(carry)
        done.append(float(m["episode_done_frac"]))
    wall = time.perf_counter() - t0
    first, last = sum(done[:5]) / 5, sum(done[-5:]) / 5
    out["cartpole_done_frac"] = done
    launched = {n: c for n, c in _counts().items() if c}
    print(f"[phase 4] cartpole PPO ({CARTPOLE_ITERS} iterations, {json.dumps(CARTPOLE_PPO)}) in "
          f"{wall:.1f} s: episode_done_frac {[round(x, 5) for x in done]}; last 5 {last:.5f} "
          f"against first 5 {first:.5f}; launches {json.dumps(launched)}")
    finite = all(bool(torch.isfinite(W).all()) for W, _ in carry[0]["actor"])
    if not (last < 0.5 * max(first, 1e-3)) or not finite or launched:
        raise AssertionError(f"cartpole PPO did not improve: first {first}, last {last}")

    _lap("penalty paths: the cartpole PPO")
    # ---- phase 3: rates beside the K2 state path, and K1 at nc 19
    env_k2 = ANYmalEnv(observe="state", device=dev)
    st_k2 = env_k2.reset(torch.Generator(device=dev).manual_seed(126), B_MAIN)
    for _ in range(5):
        st_k2 = env_k2.step(st_k2, _uniform(act_gen, dev))
    rates["ANYmal state path (K2)"], _ = _env_rate(env_k2, st_k2, act_gen, dev, STEPS, 3)
    k2 = max(rates["ANYmal state path (K2)"])
    for k, r in rates.items():
        print(f"[phase 3] env-steps/s at B={B_MAIN}, {k}: {[round(x, 1) for x in r]} (max "
              f"{max(r):.1f}, {max(r) / k2:.5f}× the K2 state path)")
    print(f"[phase 3] GPU kernel launches per env step (torch.profiler): {json.dumps(per_step)}")
    print(f"[phase 3] K1 in the gantry-penalty layout: n {gcfg.n}, nc {gcfg.nc}, {gcfg.iters} "
          f"sweeps, {_solve_flops(gcfg)} FLOP per env")
    entry(f"gantry_penalty_{cs}", "jiminy_tpu_torch/csrc/constraint_solve.cu",
          "jiminy_tpu/ops/constraint_solve.py:358", path["gantry penalty path"][cs],
          _time_cuda(lambda: solve_batched(gcfg, *k1_args, device=dev), 50),
          _time_cuda(lambda: solve_reference(gcfg, *k1_args), 5),
          _solve_bytes(gcfg, B_MAIN), _solve_flops(gcfg) * B_MAIN)
    print(f"[phase 3] the paths off the impulse engine took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---- A.15's walkers: AntEnv (ant_run, ant_sensors_run5) and SpotmicroEnv
# (spotmicro_run, spotmicro_sensors_run) as examples/train.py builds them:
# the reference's defaults, 20 substeps per env step, the ANYmal frame
WALKERS = ("ant", "spotmicro")


def _walker_env(name, dev, **kw):
    from jiminy_tpu_torch.envs import AntEnv, SpotmicroEnv

    return {"ant": AntEnv, "spotmicro": SpotmicroEnv}[name](device=dev, **kw)


def _ab_walker_substeps(env, state, act_gen, dev, kw, label):
    """One env step of a walker's state path from its own state, substep
    by substep, each substep feeding K2 (one launch at n_sub = 1) and the
    inline plain engine in float32 and float64 the same inputs: K2 held to
    the float64 engine env by env by `_gate_vs_f64` on q, v and λ. Prints
    each quantity's worst distances over the substeps."""
    inline = type(env)(constraint_solver="inline", device=dev, **kw)
    inline64 = type(env)(constraint_solver="inline", dtype=torch.float64, device=dev, **kw)
    u = env._action_to_command(_uniform(act_gen, dev, env.motors.nm), state.sim)
    sim, worst = state.sim, {}
    before = _counts()
    for i in range(env.n_substeps):
        nk = env.engine.step(sim, u, n_substeps=1)
        ni = inline.engine.step(sim, u, n_substeps=1)
        n64 = inline64.engine.step(_as_f64(state.replace(sim=sim)).sim, u.double(), n_substeps=1)
        for f in ("q", "v", "lam"):
            g = _gate_vs_f64(f"{label} K2 substep {i} {f}", getattr(nk, f), getattr(ni, f),
                             getattr(n64, f))
            w = worst.setdefault(f, dict.fromkeys(g, 0))
            for key, x in g.items():
                w[key] = max(w[key], x)
        sim = nk
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    print(f"[phase 2] {label}, one env step, K2 substep by substep vs the inline engine in f32 "
          f"and f64 on the same inputs, launches {json.dumps(launched)}; the worst over the "
          f"{env.n_substeps} substeps: " + json.dumps(worst))
    if launched != {"substep_multi": env.n_substeps}:
        raise AssertionError(f"{label}: unexpected launches {launched}")


def _as_f64(state):
    sim = type(state.sim)(**{k: getattr(state.sim, k).double() for k in state.sim.FIELDS})
    return state.replace(sim=sim, obs=state.obs.double())


def _ab_env_step(env, state, act_gen, dev):
    """One env step from the main path's state, substep by substep, each
    substep feeding every backend the same inputs:

    - K1 (``constraint_solver="kernel"``) against the inline plain engine:
      only the chain differs, and it gets the same M and J, so |Δ| ≤ 1e-4
      on q and v;
    - K2 (the env's engine, one substep per launch) against the inline
      engine in float32 and in float64 (same constants): K2 builds M, J
      and the rows itself in another order of operations, and on these
      states one substep amplifies float32 rounding to ~1e-3 in v in any
      float32 implementation (the plain one included). So the float64
      engine is the yardstick, env by env, as in phase 1 (`_gate_vs_f64`).

    The free-running env steps are reported too, beside the inline env in
    float64. Returns the numbers; raises when a gate fails."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    kw = dict(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    inline = ANYmalEnv(constraint_solver="inline", **kw)
    inline64 = ANYmalEnv(constraint_solver="inline", dtype=torch.float64, **kw)
    k1 = _anymal_engine(dev, residual=False, solver="kernel")
    plain64 = _anymal_engine(dev, torch.float64, residual=False, solver="inline")
    a = _uniform(act_gen, dev)
    u = env._action_to_command(a, state.sim)

    def gap(x, y):
        d = _env_err(x, y)
        return {"max": d.max().item(), "envs_over_1e-4": int((d > TOL).sum())}

    k1_err = {"q": 0.0, "v": 0.0}
    k2 = {"q": [], "v": [], "lam": []}
    sim = state.sim
    for i in range(env.n_substeps):
        nk = env.engine.step(sim, u, n_substeps=1)
        n1 = k1.step(sim, u, n_substeps=1)
        ni = inline.engine.step(sim, u, n_substeps=1)
        n64 = plain64.step(_as_f64(state.replace(sim=sim)).sim, u.double(), n_substeps=1)
        for f in ("q", "v"):
            k1_err[f] = max(k1_err[f], gap(getattr(n1, f), getattr(ni, f))["max"])
        if not (k1_err["q"] <= TOL and k1_err["v"] <= TOL):
            raise AssertionError(f"K1 env step disagrees with the inline engine: {k1_err}")
        for f, per_sub in k2.items():
            per_sub.append(_gate_vs_f64(f"K2 substep {i} {f}", getattr(nk, f),
                                        getattr(ni, f), getattr(n64, f)))
        sim = nk
    print(f"[phase 2] one env step, K1 substep by substep vs the inline engine on the same "
          f"inputs: max|dq|={k1_err['q']:.3g} max|dv|={k1_err['v']:.3g}")
    print("[phase 2] one env step, K2 substep by substep vs the inline engine in f32 and f64 "
          "on the same inputs: " + json.dumps(k2))

    s_k = env.step_no_reset(state, a)
    s_i = inline.step_no_reset(state, a)
    s_64 = inline64.step_no_reset(_as_f64(state), a.double())
    free = {
        "kernel_vs_inline_v": gap(s_k.sim.v, s_i.sim.v),
        "kernel_vs_inline_f64_v": gap(s_k.sim.v, s_64.sim.v),
        "inline_vs_inline_f64_v": gap(s_i.sim.v, s_64.sim.v),
    }
    print("[phase 2] free-running env step (f32 rounding compounds over 4 substeps; the "
          "f64 inline env is the yardstick): " + json.dumps(free))


SENSOR_KW = dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005,
                 step_dt=0.02, sim_dt=5e-3, pgs_iters=8)
# anymal_sim2real_run5 without model randomization (PR 7's slice)
TERRAIN_KW = dict(SENSOR_KW, terrain="fourier", push_magnitude=100.0, push_duration=0.2)
# the slice's model randomization: examples/train.py --randomize 0.2
SIM2REAL_RANDOMIZE = dict(mass_scale=(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2),
                          motor_gain=(0.9, 1.1))


def _randomization():
    from jiminy_tpu_torch.engine.randomization import ModelRandomization

    return ModelRandomization(**SIM2REAL_RANDOMIZE)


def _ab_sensor_step(env, state, act_gen, dev, kw=None, fused="substep_multi_sensors",
                    chunked="substep_multi", label="sensor path", gate=None):
    """One env step of a sensor path (the env of ``env``'s class that
    ``kw`` builds) from the same state and eps, fused (one launch of K2
    with the sensor stage, the instantiation ``fused``) and chunked (one
    launch of the sensor-free instantiation ``chunked`` at n_sub = 1 per
    sensor update, each followed by the plain update), each held env by
    env against the float64 plain env (chunked, inline engine) beside the
    float32 plain env by ``gate`` (`_gate_vs_f64` by default); the
    buffers scaled per group as in phase 1."""
    kw = kw or SENSOR_KW
    gate = gate or _gate_vs_f64
    plain = type(env)(constraint_solver="inline", device=dev, **kw)
    plain64 = type(env)(constraint_solver="inline", dtype=torch.float64, device=dev, **kw)
    a = _uniform(act_gen, dev, env.motors.nm)
    eps = env._sensor_eps(state.generator, B_MAIN, env.n_obs_updates)
    st64 = _as_f64(state)
    st64 = st64.replace(info={k: x.double() if x.is_floating_point() else x
                              for k, x in state.info.items()})
    outs, launched = {}, {}
    for name, e, st, is_fused in (("fused", env, state, True), ("chunked", env, state, False),
                                  ("plain", plain, state, False), ("plain64", plain64, st64, False)):
        e._fused_sensors = is_fused
        e._sensor_eps = lambda generator, batch_size, n_updates, bias_extra, x=eps: x.to(st.obs.dtype)
        before = _counts()
        outs[name] = e.step_no_reset(st, a.to(st.obs.dtype))
        torch.cuda.synchronize()
        launched[name] = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        del e._sensor_eps
    env._fused_sensors = True
    if launched != {"fused": {fused: 1}, "chunked": {chunked: env.n_obs_updates}, "plain": {},
                    "plain64": {}}:
        raise AssertionError(f"sensor A/B: unexpected K2 launches {launched}")
    scale = _reading_scale(env.engine._sensor_spec(env.sensors, 1),
                         outs["plain64"].info["sensor_bufs"])
    # fused against chunked: the same K2 physics (phase 1 holds the two
    # instantiations bit-equal), the in-kernel stage against the plain
    # update at each of the 4 substeps' states
    fu, ch = outs["fused"], outs["chunked"]
    same = torch.equal(fu.sim.q, ch.sim.q) and torch.equal(fu.sim.v, ch.sim.v)
    d_bufs = ((fu.info["sensor_bufs"].double() - ch.info["sensor_bufs"].double()).abs()
              / scale).max().item()
    print(f"[phase 2] {label}, fused vs chunked from the same state and eps: q, v equal "
          f"{same}; buffers max scaled |d| {d_bufs:.3g}")
    if not (same and d_bufs <= TOL):
        raise AssertionError(f"fused and chunked sensor steps differ: q, v equal {same}, "
                             f"scaled buffers {d_bufs}")
    gates = {}
    for name in ("fused", "chunked"):
        k, p32, p64 = outs[name], outs["plain"], outs["plain64"]
        gates[name] = {
            "q": gate(f"{label} env step {name} q", k.sim.q, p32.sim.q, p64.sim.q),
            "v": gate(f"{label} env step {name} v", k.sim.v, p32.sim.v, p64.sim.v),
            "bufs_scaled": gate(
                f"{label} env step {name} bufs", k.info["sensor_bufs"].double() / scale,
                p32.info["sensor_bufs"].double() / scale, p64.info["sensor_bufs"] / scale),
            "obs": gate(f"{label} env step {name} obs", k.obs, p32.obs, p64.obs),
        }
    print(f"[phase 2] {label}, one env step from the same state and eps, K2 launches "
          f"{json.dumps(launched)}, fused and chunked vs the f64 plain env: " + json.dumps(gates))


def _counters():
    """{kernel instantiation: (wrapper, its launch counter)}."""
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched, substep_batched_multi

    out = {"constraint_solve": (solve_batched, "launches")}
    for pre in ("", "rand_"):  # the nominal instantiations, then the randomized ones
        out.update({
            pre + "substep": (substep_batched, pre + "launches"),
            pre + "substep_ground": (substep_batched, pre + "ground_launches"),
            pre + "substep_multi": (substep_batched_multi, pre + "launches"),
            pre + "substep_multi_sensors": (substep_batched_multi, pre + "sensor_launches"),
            pre + "substep_multi_ground": (substep_batched_multi, pre + "ground_launches"),
            pre + "substep_multi_sensors_ground": (substep_batched_multi,
                                                   pre + "sensor_ground_launches"),
        })
    return out


def _warp_wrappers():
    """(K1, K3, K2): the wrappers whose ``warp_launches`` count their
    launches of the warp body."""
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched, substep_batched_multi

    return solve_batched, substep_batched, substep_batched_multi


def _reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    for fn in _warp_wrappers():
        fn.warp_launches = 0


def _check_warp(label, spec, launched) -> int:
    """The launches ``launched`` (counts by instantiation) of K1, K3 and K2
    all went through the warp body, in either frame, as ``spec.warp_workspace()``
    (K3, K2) and ``warp_workspace(spec.cfg)`` (K1) lay it out for every
    model inside the caps: their launches since the counts were last set
    to 0. Returns the warp launches."""
    from jiminy_tpu_torch.ops.constraint_solve import warp_workspace

    k1 = launched.get("constraint_solve", 0)
    k2 = sum(c for n, c in launched.items() if "substep_multi" in n)
    k3 = sum(c for n, c in launched.items() if "substep" in n) - k2
    if k2 or k3:
        spec.warp_workspace()  # the layout K3 and K2 ran with; raises past the caps
    if k1:
        warp_workspace(spec.cfg)  # K1's; raises for a system it does not take
    got = tuple(fn.warp_launches for fn in _warp_wrappers())
    if got != (k1, k3, k2):
        raise AssertionError(f"{label}: launches of the warp body (K1, K3, K2) {got}, expected "
                             f"all of them, {(k1, k3, k2)}")
    return sum(got)


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _only(**launched) -> dict:
    """The counts of a run that launched ``launched`` and nothing else."""
    return {name: launched.get(name, 0) for name in _counters()}


def _uniform(gen, dev, nm=12):
    return torch.rand(B_MAIN, nm, generator=gen, device=dev) * 2.0 - 1.0


def _check_finite(state, label):
    for name, x in (("q", state.sim.q), ("v", state.sim.v), ("obs", state.obs),
                    ("reward", state.reward)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name} after {label}")


def _env_rate(env, state, act_gen, dev, steps, loops):
    """env-steps/s over ``loops`` timed loops of ``steps`` env steps."""
    rates = []
    for _ in range(loops):
        acts = [_uniform(act_gen, dev, env.action_size) for _ in range(steps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        rates.append(B_MAIN * steps / (time.perf_counter() - t0))
    return rates, state


def _engine_rate(eng, walker, sim, act_gen, dev, steps, loops):
    """env-steps/s of ``eng.step`` over ``walker``'s substeps (its actions
    mapped to commands) from ``sim``, over ``loops`` timed loops of
    ``steps`` env steps, and the launches of the timed steps."""
    rates = []
    torch.cuda.synchronize()
    before = _counts()
    for _ in range(loops):
        acts = [_uniform(act_gen, dev, walker.motors.nm) for _ in range(steps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            sim = eng.step(sim, walker._action_to_command(a, sim), n_substeps=walker.n_substeps)
        torch.cuda.synchronize()
        rates.append(B_MAIN * steps / (time.perf_counter() - t0))
    return rates, {n: c - before[n] for n, c in _counts().items() if c != before[n]}


# ---- phase 4: the policy and PPO training (A.7, A.8) on the main path's
# env, at examples/train.py's ANYmal settings
PPO_B = 2048
PPO_ITERS = 20
PPO_TOTAL_ITERS = 4000  # examples/train.py's default --iters: the lr schedule's length
LEARNER_REL_TOL = 1e-5


def _ppo_cfg():
    from jiminy_tpu_torch.rl import PPOConfig

    return PPOConfig(num_envs=PPO_B, rollout_len=32, minibatches=8, epochs=4, hidden=(256, 256),
                     lr=3e-4, ent_coef=0.005, symmetry_coef=0.1, anneal_lr=True,
                     total_iters=PPO_TOTAL_ITERS)


def _learner_inputs(ppo, n, seed):
    """Seeded params (on the CPU) and a flat batch of ``n`` rows whose
    log-probs and values come from those params (ratios near 1, as in a
    run), and ``epochs`` permutations."""
    gen = torch.Generator().manual_seed(seed)
    pol = ppo.policy
    params = pol.init(gen)
    obs = torch.randn(n, pol.obs_size, generator=gen)
    with torch.no_grad():
        mean, std = pol.action_dist(params, obs)
        action = mean + std * torch.randn(n, pol.action_size, generator=gen)
        value = pol.value(params, obs)
        adv = torch.randn(n, generator=gen)
        flat = {"obs": obs, "action": action, "logp": pol.log_prob(params, obs, action),
                "value": value + 0.1 * torch.randn(n, generator=gen), "adv": adv,
                "ret": value + adv}
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(ppo.cfg.epochs)])
    return params, flat, perms


def phase_learner_vs_cpu(dev, env) -> float:
    """The learner on the card and on the CPU from the same params, flat
    batch and permutations, the symmetry loss on: one PPO update (one
    minibatch of 8,192 rows, the reference's size at B = 2048) and an
    iteration's whole learner stage (4 epochs × 8 such updates). Each
    within LEARNER_REL_TOL relative: max |Δ| over every param over max
    |param| (each leaf's own ratio is printed too; a leaf that starts at
    zero or at the output layer's scale 0.01 has no scale of its own).
    Returns the worst relative gap."""
    from jiminy_tpu_torch.rl.networks import map_params, param_leaves
    from jiminy_tpu_torch.rl.ppo import PPO, adam_init

    cfg = _ppo_cfg()
    worst = 0.0
    for label, epochs, minibatches, n in (("one update", 1, 1, PPO_B * 32 // cfg.minibatches),
                                          ("the learner stage", cfg.epochs, cfg.minibatches,
                                           PPO_B * 32)):
        ppo = PPO(env, dataclasses.replace(cfg, epochs=epochs, minibatches=minibatches),
                  env.symmetry_fn)
        params, flat, perms = _learner_inputs(ppo, n, seed=21)
        ent = ppo.ent_coef(0)
        cpu = ppo.learn(params, adam_init(params), flat, perms, ent)
        on_card = map_params(lambda x: x.to(dev), params)
        gpu = ppo.learn(on_card, adam_init(on_card), {k: v.to(dev) for k, v in flat.items()},
                        perms.to(dev), ent)
        torch.cuda.synchronize()
        pairs = list(zip(param_leaves(cpu[0]), [x.cpu() for x in param_leaves(gpu[0])]))
        gap = max((b - a).abs().max().item() for a, b in pairs)
        scale = max(a.abs().max().item() for a, _ in pairs)
        per_leaf = [f"{((b - a).abs().max() / a.abs().max()).item():.3g}" for a, b in pairs]
        moved = max((a - p).abs().max().item() for (a, _), p in zip(pairs, param_leaves(params)))
        rel = gap / scale
        worst = max(worst, rel)
        print(f"[phase 4] learner, {label} ({epochs} epoch(s) × {minibatches} minibatch "
              f"update(s) of {n // minibatches} rows, symmetry on), card vs CPU from the same "
              f"params, batch and permutations: max |Δ| {gap:.3g} over max |param| {scale:.3g} = "
              f"{rel:.3g} (gate {LEARNER_REL_TOL}); per leaf max |Δ| / max |leaf| "
              f"[{', '.join(per_leaf)}]; the params moved up to {moved:.3g}; aux card "
              f"{json.dumps({k: round(v.item(), 6) for k, v in gpu[2].items()})} CPU "
              f"{json.dumps({k: round(v.item(), 6) for k, v in cpu[2].items()})}")
        if not rel <= LEARNER_REL_TOL:
            raise AssertionError(f"the learner on the card ({label}) is {rel} from the CPU's")
    return worst


def _spread(xs) -> str:
    return (f"{[round(x, 1) for x in xs]} (mean {sum(xs) / len(xs):.1f}, spread "
            f"{(max(xs) - min(xs)) / (sum(xs) / len(xs)):.3f})")


def phase_training(dev) -> dict:
    """PPO on ``ANYmalEnv(observe="state", max_steps=500)`` at B = 2048,
    examples/train.py's settings (rollout 32, 8 × 4 minibatch updates,
    symmetry 0.1, ``anneal_lr``): 20 iterations with the launch counts set
    to 0 just before and read just after (exactly one K2 launch per rollout
    env step and no other launch); the curve, with mean ``reward_mean`` of
    iterations 15–19 ≥ 1.3 × that of 0–2; every param finite. Then the
    rates of the rollout alone, the whole iteration and the learner alone
    (3 loops each), a checkpoint round trip (params, Adam's state and both
    generators bit for bit) and ``evaluate`` of the greedy policy at 256
    envs for 50 steps (finite)."""
    import tempfile
    from pathlib import Path

    from jiminy_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.rl import evaluate, greedy_policy
    from jiminy_tpu_torch.rl.networks import param_leaves
    from jiminy_tpu_torch.rl.ppo import PPO, _gae

    env = ANYmalEnv(observe="state", max_steps=500, device=dev)
    out = {"learner_rel_err": phase_learner_vs_cpu(dev, env)}
    cfg = _ppo_cfg()
    ppo = PPO(env, cfg, env.symmetry_fn)  # make_train_fn returns its init and train_step
    carry = ppo.init(0, PPO_B)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(PPO_ITERS):
        carry, metrics = ppo.train_step(carry)
        history.append(metrics)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = _counts()
    warp = _check_warp("training", env.engine.substep_spec, got)
    steps = PPO_ITERS * cfg.rollout_len
    curve = {k: torch.stack([m[k] for m in history]).tolist() for k in history[0]}
    reward = curve["reward_mean"]
    early, late = sum(reward[:3]) / 3, sum(reward[15:20]) / 5
    print(f"[phase 4] training, {PPO_ITERS} iterations at B={PPO_B} ({steps} rollout env steps, "
          f"{steps * PPO_B} env-steps) in {train_s:.2f} s: launches "
          f"{json.dumps({n: c for n, c in got.items() if c})} (the warp body {warp})")
    for k in ("reward_mean", "episode_done_frac", "approx_kl", "entropy", "v_loss"):
        print(f"[phase 4] curve {k}: {[round(x, 4) for x in curve[k]]}")
    print(f"[phase 4] mean reward_mean over iterations 15–19 {late:.4f} against 0–2 "
          f"{early:.4f}: {late / early:.3f}× (gate 1.3×)")
    if got != _only(substep_multi=steps):
        raise AssertionError(f"training: expected {steps} K2 launches and no other, saw {got}")
    if not late >= 1.3 * early:
        raise AssertionError(f"training did not learn: reward_mean {early} → {late}")
    params = carry[0]
    if not all(bool(torch.isfinite(x).all()) for x in param_leaves(params)):
        raise AssertionError("training: non-finite params")
    _check_finite(carry[2], "training")

    # ---- rates: the rollout alone, the whole iteration, the learner alone
    n = PPO_B * cfg.rollout_len
    roll, whole, learn = [], [], []
    states, gen = carry[2], carry[3]
    for _ in range(3):
        noise = ppo.draw_noise(gen, PPO_B, torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, traj = ppo.rollout(params, states, noise)
        torch.cuda.synchronize()
        roll.append(n / (time.perf_counter() - t0))
    with torch.no_grad():
        adv, ret = _gae(traj, cfg.gamma, cfg.lam)
    flat = ppo.flatten(traj, adv, ret)
    perms = torch.stack([torch.randperm(n, generator=gen, device=dev) for _ in range(cfg.epochs)])
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppo.learn(params, carry[1], flat, perms, ppo.ent_coef(carry[4]))
        torch.cuda.synchronize()
        learn.append(time.perf_counter() - t0)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = ppo.train_step(carry)
        torch.cuda.synchronize()
        whole.append(n / (time.perf_counter() - t0))
    it_s = sum(n / r for r in whole) / 3
    share = sum(learn) / 3 / it_s
    print(f"[phase 4] env-steps/s at B={PPO_B}, rollout alone (the policy's samples and values "
          f"and {cfg.rollout_len} env steps): {_spread(roll)}")
    print(f"[phase 4] env-steps/s at B={PPO_B}, rollout + learner (train_step): {_spread(whole)}")
    print(f"[phase 4] the learner alone (GAE excluded; {cfg.epochs * cfg.minibatches} updates): "
          f"{[round(1e3 * t, 2) for t in learn]} ms; its share of the iteration "
          f"({1e3 * it_s:.2f} ms): {share:.3f}")
    out.update(rollout=roll, train_step=whole, learner_ms=[1e3 * t for t in learn],
               learner_share=share, reward_curve=reward)

    # ---- checkpoint round trip, then evaluate the restored policy
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        path = Path(tmp) / "carry.pt"
        save_checkpoint(path, carry)
        size = path.stat().st_size
        restored = restore_checkpoint(path, carry)
    same = {
        "params": all(torch.equal(a, b) for a, b in zip(param_leaves(carry[0]),
                                                          param_leaves(restored[0]))),
        "adam": torch.equal(carry[1]["count"], restored[1]["count"]) and all(
            torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(carry[1][k], restored[1][k])),
        "run generator": torch.equal(carry[3].get_state(), restored[3].get_state()),
        "env generator": torch.equal(carry[2].generator.get_state(),
                                     restored[2].generator.get_state()),
        "env obs": torch.equal(carry[2].obs, restored[2].obs),
        "iteration": carry[4] == restored[4],
    }
    print(f"[phase 4] checkpoint of the carry ({size} B), restored bit for bit: {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"checkpoint round trip: {same}")
    _reset_counts()
    stats = evaluate(env, greedy_policy(ppo.policy, restored[0]), n_envs=256, n_steps=50,
                     generator=torch.Generator(device=dev).manual_seed(123))
    got = _counts()
    print(f"[phase 4] evaluate of the restored greedy policy, 256 envs × 50 steps: "
          f"{json.dumps(stats)}; launches {json.dumps({n: c for n, c in got.items() if c})}")
    if not all(torch.isfinite(torch.tensor(v)) for v in stats.values()):
        raise AssertionError(f"evaluate: non-finite statistics {stats}")
    if got != _only(substep_multi=50):
        raise AssertionError(f"evaluate: expected 50 K2 launches, saw {got}")
    return out


# ---- phase 5: the declarative layer (A.17) on the sensor path: the
# anymal_sensors_run5 recipe (mahony,stack:4) over the declarative MDP
PIPELINE = [{"type": "mahony"}, {"type": "stack", "n": 4}]
DECL_STEPS = 40  # the A/B's env steps; the legs folded over the second half
DECL_REWARD_TOL = 1e-5  # tests/test_compositions_dogfood.py's


def _leaves(x) -> list:
    """Every tensor of a carry (generators as their states), in order."""
    from jiminy_tpu_torch.engine.engine import SimState
    from jiminy_tpu_torch.envs.base import EnvState
    from jiminy_tpu_torch.envs.pipeline import WrapperState

    if isinstance(x, (WrapperState, EnvState, SimState)):
        return _leaves(vars(x))
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    if isinstance(x, torch.Generator):
        return [x.get_state()]
    return [x] if torch.is_tensor(x) else []


def _mdp_rollout(env, dev, seed):
    """DECL_STEPS env steps from a fresh batch, uniform actions and then
    the legs folded (constant −1): the (T, B) rewards and terminations."""
    st = env.reset(torch.Generator(device=dev).manual_seed(seed), B_MAIN)
    act_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rew, term = [], []
    for i in range(DECL_STEPS):
        a = _uniform(act_gen, dev) if i < DECL_STEPS // 2 else -torch.ones(B_MAIN, 12, device=dev)
        st = env.step(st, a)
        rew.append(st.reward)
        term.append(st.terminated)
    return torch.stack(rew), torch.stack(term)


def phase_declarative(dev) -> dict:
    """The declarative layer on the card: ``build_pipeline(ANYmalEnv(
    **SENSOR_KW, <anymal_declarative_mdp>), [mahony, stack:4])`` at B =
    4096 (obs 4 × 37 = 148): 25 env steps with the counts set to 0 just
    before and read just after, exactly one launch of K2 with the sensor
    stage per env step and no other; the profiler's launches per env step
    and idle share of the pipeline and of the bare sensor env
    (``tools/profile_env_step.py``'s ``profile_env``); the declarative MDP
    against the hand-coded one on the sensor path from one generator and
    the same actions (the second half folding the legs): identical
    terminations (some), rewards within 1e-5; the declarative state path,
    one K2 launch per env step; env-steps/s of the pipeline and of the
    bare sensor env, 3 loops of 25 steps each; three PPO iterations at B =
    2048 through ``tools/train.py``'s ``main`` (``--pipeline
    mahony,stack:4 --mdp declarative``, ``--max-steps 50``): one K2 with
    the sensor stage per rollout and evaluation step and no other launch,
    ``reward_mean`` finite; its carry (a ``WrapperState``) through
    ``CheckpointManager`` bit for bit; ``freeze_pipeline_stats`` of a
    ``stack:4,normalize`` state: the batch mean of the per-env
    statistics."""
    import tempfile
    from pathlib import Path

    from jiminy_tpu_torch.checkpoint import CheckpointManager
    from jiminy_tpu_torch.envs import (
        ANYmalEnv,
        anymal_declarative_mdp,
        build_pipeline,
        freeze_pipeline_stats,
    )
    from jiminy_tpu_torch.rl import read_metrics
    from jiminy_tpu_torch.tools import train as tool_train
    from jiminy_tpu_torch.tools.profile_env_step import profile_env

    out = {}
    r, t = anymal_declarative_mdp()
    decl = ANYmalEnv(device=dev, reward_fn=r, termination_fn=t, **SENSOR_KW)
    env = build_pipeline(decl, PIPELINE)
    bare = ANYmalEnv(device=dev, **SENSOR_KW)
    if not (decl._fused_sensors and bare._fused_sensors) or env.observation_size != 148:
        raise AssertionError(f"pipeline: fused {decl._fused_sensors}, obs {env.observation_size}")
    if hasattr(env, "symmetry_fn"):
        raise AssertionError("the pipeline passes the inner env's mirror on")

    # ---- 1. launches on the pipeline path, then the profiler beside the bare env
    act_gen = torch.Generator(device=dev).manual_seed(40)
    st = env.reset(torch.Generator(device=dev).manual_seed(41), B_MAIN)
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(STEPS):
        st = env.step(st, _uniform(act_gen, dev))
    torch.cuda.synchronize()
    got = _counts()
    warp = _check_warp("pipeline path", decl.engine.substep_spec, got)
    print(f"[phase 5] pipeline path (mahony, stack:4, declarative MDP), {STEPS} env steps at "
          f"B={B_MAIN}: launches {json.dumps({n: c for n, c in got.items() if c})} (the warp "
          f"body {warp}); obs {tuple(st.obs.shape)}")
    if got != _only(substep_multi_sensors=STEPS) or st.obs.shape != (B_MAIN, 148):
        raise AssertionError(f"pipeline path: launches {got}, obs {tuple(st.obs.shape)}")
    _check_finite(st, "pipeline path")
    quat = st.obs[:, 33:37]
    print(f"[phase 5] pipeline path: |attitude estimate| {quat.norm(dim=1).min().item():.6f}–"
          f"{quat.norm(dim=1).max().item():.6f}; done this step {int(st.done.sum())}")
    for name, e in (("pipeline", env), ("bare sensor env", bare)):
        prof = profile_env(e, B_MAIN, 5)
        out[f"profile_{name}"] = prof
        print(f"[phase 5] profiler, {name}, B={B_MAIN}: {json.dumps(prof)}")

    # ---- 2. the declarative MDP against the hand-coded one; the state path
    rew_d, term_d = _mdp_rollout(decl, dev, 42)
    rew_h, term_h = _mdp_rollout(bare, dev, 42)
    gap = (rew_d - rew_h).abs().max().item()
    n_term = int(term_h.sum())
    print(f"[phase 5] declarative vs hand-coded MDP, {DECL_STEPS} sensor-path steps at "
          f"B={B_MAIN} (legs folded from step {DECL_STEPS // 2}): terminations "
          f"{int(term_d.sum())} / {n_term}, identical {torch.equal(term_d, term_h)}; rewards max "
          f"|d| {gap:.3g} (gate {DECL_REWARD_TOL})")
    if not (torch.equal(term_d, term_h) and n_term > 0 and gap <= DECL_REWARD_TOL):
        raise AssertionError(f"declarative MDP: terminations {int(term_d.sum())} / {n_term}, "
                             f"rewards {gap}")
    out.update(mdp_reward_gap=gap, mdp_terminations=n_term)
    state_decl = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8,
                           reward_fn=r, termination_fn=t, device=dev)
    st_s = state_decl.reset(torch.Generator(device=dev).manual_seed(43), B_MAIN)
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(10):
        st_s = state_decl.step(st_s, _uniform(act_gen, dev))
    torch.cuda.synchronize()
    got = _counts()
    print(f"[phase 5] declarative state path, 10 env steps: launches "
          f"{json.dumps({n: c for n, c in got.items() if c})}")
    if got != _only(substep_multi=10):
        raise AssertionError(f"declarative state path: launches {got}")
    _check_finite(st_s, "declarative state path")

    # ---- 3. rates, the pipeline and the bare sensor env in turns
    st_b = bare.reset(torch.Generator(device=dev).manual_seed(44), B_MAIN)
    for _ in range(5):  # warm-up
        st_b = bare.step(st_b, _uniform(act_gen, dev))
    rates_p, st = _env_rate(env, st, act_gen, dev, STEPS, 3)
    rates_b, _ = _env_rate(bare, st_b, act_gen, dev, STEPS, 3)
    print(f"[phase 5] env-steps/s at B={B_MAIN}, pipeline (mahony, stack:4, declarative MDP): "
          f"{_spread(rates_p)}")
    print(f"[phase 5] env-steps/s at B={B_MAIN}, bare sensor env: {_spread(rates_b)} (the "
          f"pipeline {sum(rates_p) / sum(rates_b):.3f}× of it)")
    print(f"[phase 5] {_gpu_line()}")
    out.update(env_steps_per_s_pipeline=rates_p, env_steps_per_s_bare_sensor=rates_b)

    # ---- 4. training through tools/train.py, the checkpoint, the frozen statistics
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        run_dir = Path(tmp) / "run"
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        env_t, carry, stats = tool_train.main([
            "--env", "anymal", "--observe", "sensors", "--sensor-delay", "0.004",
            "--imu-noise", "0.02", "--encoder-noise", "0.005", "--mdp", "declarative",
            "--pipeline", "mahony,stack:4", "--iters", "3", "--num-envs", str(PPO_B),
            "--max-steps", "50", "--device", dev.type, "--out", str(run_dir)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = _counts()
        rows = read_metrics(run_dir)
        reward = [row["reward_mean"] for row in rows]
        steps = 3 * 32 + 49  # the rollouts' env steps and the evaluation's
        print(f"[phase 5] tools/train.py --pipeline mahony,stack:4 --mdp declarative, 3 "
              f"iterations at B={PPO_B} and the evaluation (256 envs × 49 steps) in "
              f"{train_s:.2f} s: launches {json.dumps({n: c for n, c in got.items() if c})}; "
              f"reward_mean {reward}; eval {json.dumps(stats)}")
        if got != _only(substep_multi_sensors=steps):
            raise AssertionError(f"training: expected {steps} sensor K2 launches, saw {got}")
        if not (reward and all(torch.isfinite(torch.tensor(reward)))):
            raise AssertionError(f"training: reward_mean {reward}")
        mgr = CheckpointManager(Path(tmp) / "ckpt")
        mgr.save(3, carry)
        restored = mgr.restore(carry)
    a, b = _leaves(carry), _leaves(restored)
    same = len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
    print(f"[phase 5] the carry's checkpoint (a WrapperState of {len(a)} tensors) restored bit "
          f"for bit: {same}")
    if not same or type(restored[2]).__name__ != "WrapperState":
        raise AssertionError("the pipeline carry's checkpoint does not round-trip")
    norm = build_pipeline(bare, [{"type": "stack", "n": 4}, {"type": "normalize"}])
    st_n = norm.reset(torch.Generator(device=dev).manual_seed(45), PPO_B)
    for _ in range(5):
        st_n = norm.step(st_n, _uniform(act_gen, dev)[:PPO_B])
    frozen = freeze_pipeline_stats(norm, st_n)
    want = st_n.layer["mean"].double().mean(0).float()
    fresh = frozen.reset(torch.Generator(device=dev).manual_seed(46), 4)
    held = torch.equal(frozen.stats["mean"], want) and torch.equal(fresh.layer["mean"][3], want)
    print(f"[phase 5] freeze_pipeline_stats of a stack:4,normalize state (B={PPO_B}, 5 steps): "
          f"the batch mean of the per-env statistics {held}; count {st_n.layer['count'][0].item()}")
    if not held:
        raise AssertionError("freeze_pipeline_stats is not the batch mean of the statistics")
    out.update(train_s=train_s, reward_mean=reward)
    return out


# ---- phase 6: the URDF builders (A.20) and scale-out (A.18)
CAPSULE_FEET = dict(foot_radius=0.02, foot_len=0.08)  # tests/test_collision.py's capsule feet
URDF_STEPS = 10
RING_CFG = dict(rollout_len=32, minibatches=8, epochs=4, hidden=(256, 256), lr=3e-4,
                ent_coef=0.005, symmetry_coef=0.1, anneal_lr=True, total_iters=PPO_TOTAL_ITERS)
RING_WORKER = """
import json, time
from chip_smoke import _digest
from jiminy_tpu_torch.checkpoint import CheckpointManager
from jiminy_tpu_torch.envs import ANYmalEnv
from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi
from jiminy_tpu_torch.rl import PPOConfig
from jiminy_tpu_torch.rl.distributed import make_distributed_train

env = ANYmalEnv(observe="state", max_steps=500, device="cuda")
init_fn, train_step, _ = make_distributed_train(env, PPOConfig(**{cfg}),
                                                symmetry_fn=env.symmetry_fn)
mgr = CheckpointManager({ckpt!r})
carry = init_fn(0) if {mode!r} == "save" else mgr.restore(init_fn(0))
launches, seconds = [], []
for i in range({iters}):
    if {mode!r} == "save" and i == {iters} // 2:
        mgr.save(i, carry)
    torch.cuda.synchronize()
    before, t0 = substep_batched_multi.launches, time.perf_counter()
    carry, metrics = train_step(carry)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    launches.append(substep_batched_multi.launches - before)
print("RING " + json.dumps({{"rank": dist.get_rank(), "batch": carry[2].obs.shape[0],
                            "launches": launches, "seconds": seconds,
                            "digest": _digest(carry, metrics),
                            "reward_mean": float(metrics["reward_mean"])}}), flush=True)
"""


def _digest(carry, metrics) -> dict:
    """A PPO carry and its metrics as sha256 digests of their parts
    (params; Adam's moments and count; the env state with its info; the
    env and run generators; the metrics) and the iteration."""
    import hashlib

    from jiminy_tpu_torch.rl.networks import param_leaves

    def sha(tensors):
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    params, opt, st, gen, it = carry
    return {
        "params": sha(param_leaves(params)),
        "adam": sha([opt["count"], *opt["mu"], *opt["nu"]]),
        "env": sha([getattr(st.sim, k) for k in st.sim.FIELDS]
                   + [st.obs, st.reward, st.terminated, st.truncated, st.steps]
                   + [st.info[k] for k in sorted(st.info)]),
        "generators": sha([st.generator.get_state(), gen.get_state()]),
        "metrics": sha([metrics[k] for k in sorted(metrics)]),
        "iteration": it,
    }


def _restore_at_world_size_one(ckpt: str, cfg: dict) -> dict:
    """Run in a child process (`_in_child`): the 2-rank checkpoint in
    ``ckpt`` restored through ``make_distributed_train`` at world size 1
    over NCCL, and ``PPO.train_step`` from ``restore_raw``'s global carry
    with rank 0's generators, 2 iterations each on ANYmal at ``cfg``:
    each run's batch, K2 launches per iteration and `_digest`."""
    import torch.distributed as dist

    from jiminy_tpu_torch.checkpoint import CheckpointManager, restore_raw
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi
    from jiminy_tpu_torch.rl import PPOConfig
    from jiminy_tpu_torch.rl.distributed import make_distributed_train
    from jiminy_tpu_torch.rl.launch import initialize_cluster
    from jiminy_tpu_torch.rl.ppo import PPO

    initialize_cluster(num_processes=1, process_id=0, backend="nccl")
    try:
        env = ANYmalEnv(observe="state", max_steps=500, device="cuda")
        cfg = PPOConfig(**cfg)
        init_fn, d_step, _ = make_distributed_train(env, cfg, symmetry_fn=env.symmetry_fn)
        params, opt, st, gens, it = restore_raw(ckpt, device="cuda")
        runs = {"restored": (d_step, CheckpointManager(ckpt).restore(init_fn(0))),
                "single": (PPO(env, cfg, env.symmetry_fn).train_step,
                           (params, opt, st.replace(generator=st.generator[0]), gens[0], it))}
        out = {}
        for name, (step, carry) in runs.items():
            launches = []
            for _ in range(2):
                torch.cuda.synchronize()
                before = substep_batched_multi.launches
                carry, metrics = step(carry)
                torch.cuda.synchronize()
                launches.append(substep_batched_multi.launches - before)
            out[name] = {"batch": carry[2].obs.shape[0], "launches": launches,
                         "digest": _digest(carry, metrics)}
        return out
    finally:
        dist.destroy_process_group()


def _ring(mode, cfg, ckpt, iters) -> tuple[list, float]:
    """One ring of 2 gloo ranks running ``RING_WORKER``: each rank's
    report, rank order, and the ring's seconds with its processes' start."""
    from jiminy_tpu_torch.rl.launch import launch_cpu_ring

    t0 = time.perf_counter()
    logs = launch_cpu_ring(2, RING_WORKER.format(cfg=repr(cfg), iters=iters, mode=mode,
                                                 ckpt=str(ckpt)), timeout=600)
    ring = sorted((json.loads(line[5:]) for log in logs for line in log.splitlines()
                   if line.startswith("RING ")), key=lambda r: r["rank"])
    if [r["rank"] for r in ring] != [0, 1]:
        raise AssertionError(f"the {mode} ring reported {ring}")
    return ring, time.perf_counter() - t0


def _capsule_robot(dev, dtype=torch.float32):
    """The capsule-foot ANYmal through the URDF route, and its params."""
    from jiminy_tpu_torch.models.quadruped import ANYMAL, quadruped_hardware, quadruped_urdf
    from jiminy_tpu_torch.robot import build_robot

    p = dataclasses.replace(ANYMAL, **CAPSULE_FEET)
    return build_robot(quadruped_urdf(p), quadruped_hardware(p), freeflyer=True, device=dev,
                       dtype=dtype), p


def _robot_engine(robot, dt, dtype=torch.float32):
    """``robot``'s whole-substep engine at ``dt``, 8 PGS sweeps, PD 80/2,
    as the walker envs build it."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController

    opts = EngineOptions(contact_model="constraint", dt=dt, pgs_iters=8,
                         compute_solver_residual=False, constraint_solver="substep")
    return Engine(robot.tree.to(dtype=dtype), opts, motors=robot.motors.to(dtype=dtype),
                  controller=PDController(80.0, 2.0), device=robot.tree.device)


def _capsule_gate(label, eng, eng64, eng_cpu, args) -> float:
    """K2 at n_sub = 1 from ``args`` against the plain version in float32
    and float64, env by env (`_gate_vs_f64`); returns max |K2 − plain
    f32|. Printed beside it, for the 8 envs where K2's v is farthest from
    float64: the plain float32 version on the CPU (``eng_cpu``), a second
    float32 rounding of the same physics."""
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi, substep_multi_reference

    k2 = substep_batched_multi(eng.substep_spec, 1, *args)
    p32 = substep_multi_reference(eng.substep_spec, 1, *args)
    p64 = substep_multi_reference(eng64.substep_spec, 1, *[x.double() for x in args])
    torch.cuda.synchronize()
    names = ("q", "v", "lam", "residual", "impulse")
    err = {n: _max_err(a, b) for n, a, b in zip(names, k2, p32)}
    loaded = float((p64[4][..., 2] != 0).any(1).double().mean())
    far = torch.topk(_env_err(k2[1], p64[1]), 8).indices
    cpu = substep_multi_reference(eng_cpu.substep_spec, 1, *[x[far].cpu() for x in args])
    print(f"[phase 6] {label}: the 8 envs where K2's v is farthest from f64, |v − f64| of K2 "
          f"{[f'{x:.3g}' for x in _env_err(k2[1][far], p64[1][far]).tolist()]}, of the plain "
          f"f32 version on the card {[f'{x:.3g}' for x in _env_err(p32[1][far], p64[1][far]).tolist()]}"
          f" and on the CPU {[f'{x:.3g}' for x in _env_err(cpu[1], p64[1][far].cpu()).tolist()]}")
    gates = {n: _gate_vs_f64(f"{label} {n}", k2[i], p32[i], p64[i])
             for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))}
    print(f"[phase 6] {label} B={args[0].shape[0]}: share of envs with a loaded site {loaded:.4f}; "
          f"max |K2 − plain f32| {json.dumps(err)}; vs the f64 plain version {json.dumps(gates)}")
    if loaded < 0.5:
        raise AssertionError(f"{label}: {loaded} of the envs loaded")
    return max(err.values())


def _capsule_deep_gate(label, eng, eng64, args) -> float:
    """K2 at n_sub = 1 from ``args`` (feet 2–4 cm inside the ground)
    against the plain version in float32 and float64. Over the batch: the
    distribution rules (`_gate_dist_vs_f64`), and `_gate_vs_f64`'s
    per-env rule with its 1 % of exceptions. Each exception (the 8 farthest
    from float64 if there are more) is held by its own rounding ensemble:
    1024 copies of the env with the joints of q moved by 1e-7·N(0, 1),
    about one float32 ulp, K2 and the plain version in float32 against
    float64 on each copy by the distribution rules. q sets M, J and the
    Delassus matrix; where the solve amplifies their float32 rounding, the
    plain version's own distance to float64 spreads over the copies, and
    K2 must fall in that spread. Returns max |K2 − plain f32| over the
    batch."""
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi, substep_multi_reference

    def outs(a):
        k2 = substep_batched_multi(eng.substep_spec, 1, *a)
        p32 = substep_multi_reference(eng.substep_spec, 1, *a)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *[x.double() for x in a])
        torch.cuda.synchronize()
        return k2, p32, p64

    fields = ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse"))
    k2, p32, p64 = outs(args)
    B, dev = args[0].shape[0], args[0].device
    worse = torch.zeros(B, dtype=torch.bool, device=dev)
    for i, _ in fields:
        worse |= _env_err(k2[i], p64[i]) > 2.0 * _env_err(p32[i], p64[i]) + TOL
    gates = {n: _gate_dist_vs_f64(f"{label} {n}", k2[i], p32[i], p64[i], worst_of=~worse)
             for i, n in fields}
    err = {n: _max_err(a, b) for n, a, b in zip(("q", "v", "lam", "residual", "impulse"), k2, p32)}
    print(f"[phase 6] {label} B={B}: {int(worse.sum())} envs where K2 is further from f64 than 2 "
          f"× the plain f32 version + 1e-4; max |K2 − plain f32| {json.dumps(err)}; vs the f64 "
          f"plain version {json.dumps(gates)}")
    if worse.double().mean() > ENV_EXCEPTIONS:
        raise AssertionError(f"{label}: K2 is further from f64 than 2 × the plain f32 version "
                             f"+ 1e-4 in more than 1 % of the envs ({int(worse.sum())})")
    dk = _env_err(k2[1], p64[1])
    qi = list(eng.motors.q_idx)
    gen = torch.Generator(device=dev).manual_seed(55)
    for e in sorted(worse.nonzero().flatten().tolist(), key=lambda e: -dk[e].item())[:8]:
        copies = [x[e:e + 1].repeat(1024, 1) for x in args]
        copies[0][:, qi] += 1e-7 * torch.randn(1024, len(qi), generator=gen, device=dev)
        ek2, ep32, ep64 = outs(copies)
        ens = {n: _gate_dist_vs_f64(f"{label} env {e}'s ensemble {n}", ek2[i], ep32[i], ep64[i])
               for i, n in fields}
        print(f"[phase 6] {label}: env {e}, |v − f64| of K2 {dk[e].item():.4g}, of the plain f32 "
              f"version {_env_err(p32[1][e:e + 1], p64[1][e:e + 1]).item():.4g}; its ensemble "
              f"of 1024 copies, q's joints moved by 1e-7·N(0, 1): {json.dumps(ens)}")
    return max(err.values())


def _carries_equal(a, b) -> dict:
    """Which parts of two PPO carries and metrics ((carry, metrics)) are
    bit-identical."""
    from jiminy_tpu_torch.rl.networks import param_leaves

    (ca, ma), (cb, mb) = a, b
    return {
        "params": all(torch.equal(x, y) for x, y in zip(param_leaves(ca[0]), param_leaves(cb[0]))),
        "adam": torch.equal(ca[1]["count"], cb[1]["count"]) and all(
            torch.equal(x, y) for k in ("mu", "nu") for x, y in zip(ca[1][k], cb[1][k])),
        "metrics": set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma),
        "env obs": torch.equal(ca[2].obs, cb[2].obs),
    }


def phase_urdf_and_scaleout(dev, drive, entry, main_err, path) -> dict:
    """Phase 6 (see the module's docstring) with ``run``'s ``drive``,
    ``entry``, ``main_err`` and ``path``; returns its numbers."""
    from pathlib import Path

    import torch.distributed as dist

    from jiminy_tpu_torch.checkpoint import restore_raw
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.envs.locomotion import WalkerEnv
    from jiminy_tpu_torch.models.humanoid import atlas_stand_q
    from jiminy_tpu_torch.models.quadruped import stand_q
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi, substep_multi_reference
    from jiminy_tpu_torch.rl import PPOConfig
    from jiminy_tpu_torch.rl.distributed import make_distributed_train
    from jiminy_tpu_torch.rl.launch import dryrun_multichip, initialize_cluster
    from jiminy_tpu_torch.rl.ppo import PPO
    from jiminy_tpu_torch.robot import build_robot

    out = {}
    data = Path(__file__).resolve().parent / "data"
    main_kw = dict(step_dt=0.02, sim_dt=5e-3, pgs_iters=8, observe="state", device=dev)

    # ---- the URDF path: ANYmal and Atlas from data/
    robot = build_robot(data / "anymal.urdf", data / "anymal_hardware.toml", freeflyer=True,
                        device=dev)
    env_u = WalkerEnv(robot, stand_pose=stand_q(robot.tree), **main_kw)
    drive("urdf anymal state path", env_u, 50, URDF_STEPS, substep_multi=URDF_STEPS)
    u_eng = _robot_engine(robot, 5e-3)
    u_args = _substep_inputs(u_eng, torch.Generator(device=dev).manual_seed(51), B_MAIN)
    k2 = substep_batched_multi(u_eng.substep_spec, 1, *u_args)
    p32 = substep_multi_reference(u_eng.substep_spec, 1, *u_args)
    torch.cuda.synchronize()
    err = {n: _max_err(a, b) for n, a, b in zip(("q", "v", "lam", "residual", "impulse"), k2, p32)}
    print(f"[phase 6] urdf anymal K2 n_sub=1 B={B_MAIN}: max |K2 − plain f32| {json.dumps(err)} "
          f"(gate {TOL})")
    if max(err.values()) > TOL:
        raise AssertionError(f"urdf anymal: K2 off its plain version by {err}")
    main_err["urdf_anymal_substep_multi"] = max(err.values())

    atlas = build_robot(data / "atlas.urdf", data / "atlas_hardware.toml", freeflyer=True,
                        device=dev)
    env_a = WalkerEnv(atlas, stand_pose=atlas_stand_q(atlas.tree), step_dt=0.02, sim_dt=4e-3, kp=300.0,
                      kd=15.0, action_scale=0.4, target_speed=0.3, min_height=0.55,
                      observe="state", device=dev)
    a_spec = env_a.engine.substep_spec
    print(f"[phase 6] urdf atlas with the torso flexibility: nb {atlas.tree.nb}, nq "
          f"{atlas.tree.nq}, nv {atlas.tree.nv}, nc {env_a.engine.nc}; backend "
          f"{env_a.engine.backend!r}")
    if env_a.engine.backend != "substep":
        raise AssertionError("the URDF Atlas does not take the whole-substep kernel")
    a_spec.warp_workspace()  # raises past K2's caps
    drive("urdf atlas (torso flexibility) state path", env_a, 52, URDF_STEPS,
          substep_multi=URDF_STEPS)

    # ---- the capsule-foot ANYmal: K2's sphere-site branch at nc 36
    cap, p = _capsule_robot(dev)
    cap64, _ = _capsule_robot(dev, torch.float64)
    cap_cpu, _ = _capsule_robot(torch.device("cpu"))
    env_c = WalkerEnv(cap, stand_pose=stand_q(cap.tree, p), max_steps=100, reset_noise=0.02,
                      min_height=0.4, observe="state", device=dev)
    c_eng, c_eng64 = _robot_engine(cap, env_c.engine.options.dt), _robot_engine(
        cap64, env_c.engine.options.dt, torch.float64)
    c_spec = c_eng.substep_spec
    if not (c_spec.spheres and c_spec.nc == 36 and env_c.engine.backend == "substep"):
        raise AssertionError(f"capsule feet: spheres {c_spec.spheres}, nc {c_spec.nc}, backend "
                             f"{env_c.engine.backend}")
    c_cpu = _robot_engine(cap_cpu, env_c.engine.options.dt)
    c_args = _substep_inputs(c_eng, torch.Generator(device=dev).manual_seed(53), B_MAIN,
                             stand=stand_q(cap.tree, p))
    worst = _capsule_gate("capsule feet, perturbed stand poses", c_eng, c_eng64, c_cpu, c_args)
    d_args = _substep_inputs(c_eng, torch.Generator(device=dev).manual_seed(53), B_MAIN)
    worst = max(worst, _capsule_deep_gate("capsule feet, bare-foot stand poses (2–4 cm deep)",
                                          c_eng, c_eng64, d_args))
    st = env_c.reset(torch.Generator(device=dev).manual_seed(54), B_MAIN)
    zero = torch.zeros(B_MAIN, 12, device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(25):  # 0.5 s, tests/test_collision.py's test_capsule_feet_stand
        st = env_c.step(st, zero)
    torch.cuda.synchronize()
    path["capsule feet stand"] = got = _counts()
    warp = _check_warp("capsule feet stand", env_c.engine.substep_spec, got)
    z = st.sim.q[:, 2]
    print(f"[phase 6] capsule feet stand, 25 env steps of {env_c.n_substeps} substeps at "
          f"B={B_MAIN}, zero actions: launches {json.dumps({n: c for n, c in got.items() if c})} "
          f"(the warp body {warp}); base height {z.min().item():.4f}–{z.max().item():.4f} m; "
          f"terminated {int(st.terminated.sum())}")
    if got != _only(substep_multi=25):
        raise AssertionError(f"capsule feet stand: {got}")
    _check_finite(st, "capsule feet stand")
    if not (bool((z > 0.45).all()) and not bool(st.terminated.any())):
        raise AssertionError("capsule feet: a base fell below 0.45 m or an env terminated")
    qi = list(c_eng.motors.q_idx)
    s_args = [st.sim.q, st.sim.v, st.sim.q[:, qi], st.sim.lam,
              torch.zeros(B_MAIN, 6, device=dev)]
    worst = max(worst, _capsule_gate("capsule feet, the stand run's states", c_eng, c_eng64,
                                     c_cpu, s_args))
    main_err["capsule_feet_substep_multi"] = worst

    # ---- scale-out: world size 1 over NCCL against the single-device step
    cfg = _ppo_cfg()
    env = ANYmalEnv(observe="state", max_steps=500, device=dev)
    initialize_cluster(num_processes=1, process_id=0, backend="nccl")
    try:
        init_fn, d_step, _ = make_distributed_train(env, cfg, symmetry_fn=env.symmetry_fn)
        ppo = PPO(env, cfg, env.symmetry_fn)
        carries = {"distributed": init_fn(0), "single": ppo.init(0, PPO_B)}
        steps = {"distributed": d_step, "single": ppo.train_step}
        first, launched = {}, {}
        for name in ("distributed", "single"):
            torch.cuda.synchronize()
            _reset_counts()
            first[name] = steps[name](carries[name])
            torch.cuda.synchronize()
            launched[name] = _counts()
            carries[name] = first[name][0]
        same = _carries_equal(first["distributed"], first["single"])
        print(f"[phase 6] PPO at B={PPO_B} through make_distributed_train at world size 1 over "
              f"NCCL against the single-device train_step, one iteration from the same init: "
              f"bit-identical {json.dumps(same)}; K2 launches "
              f"{json.dumps({k: v['substep_multi'] for k, v in launched.items()})}")
        if not all(same.values()):
            raise AssertionError(f"world size 1 differs from the single-device step: {same}")
        for name, got in launched.items():
            if got != _only(substep_multi=cfg.rollout_len):
                raise AssertionError(f"{name} train step: {got}")
        times = {"distributed": [], "single": []}
        for name in ("distributed", "single", "single", "distributed"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carries[name], _ = steps[name](carries[name])
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
        print(f"[phase 6] iteration ms at B={PPO_B} (rollout {cfg.rollout_len}, "
              f"{cfg.epochs} × {cfg.minibatches} updates), in turns: world size 1 "
              f"{[round(t, 2) for t in times['distributed']]}, single device "
              f"{[round(t, 2) for t in times['single']]}")
        out["iteration_ms"] = times
        out["dryrun_realistic_reward_mean"] = dryrun_multichip(1, realistic=True, device=dev)
    finally:
        dist.destroy_process_group()

    # ---- K2 on the URDF ANYmal and on the capsule feet: time, plain, bound
    for name, eng, n_sub, args, launched_by in (
            ("urdf_anymal_substep_multi", u_eng, env_u.n_substeps, u_args,
             "urdf anymal state path"),
            ("capsule_feet_substep_multi", c_eng, env_c.n_substeps, c_args,
             "capsule feet stand")):
        spec = eng.substep_spec
        ops = B_MAIN * (n_sub * (_substep_flops(spec) + _torque_flops(spec)) + 2 * spec.tree.nv)
        entry(
            name, WARP_SOURCE,
            "jiminy_tpu/ops/substep_kernel.py:1815" if name.startswith("urdf")
            else "jiminy_tpu/ops/substep_kernel.py:862",
            path[launched_by]["substep_multi"],
            _time_cuda(lambda: substep_batched_multi(spec, n_sub, *args), 20),
            _time_cuda(lambda: substep_multi_reference(spec, n_sub, *args), 3),
            _substep_multi_bytes(spec, B_MAIN), ops,
        )
    # ---- two ranks over gloo on this card: 4 iterations, a checkpoint
    # after the second; fresh ranks restore it and run the last 2
    ring_cfg = dict(RING_CFG, num_envs=PPO_B)
    with tempfile.TemporaryDirectory() as ckpt:
        ring, sec = _ring("save", ring_cfg, ckpt, 4)
        print(f"[phase 6] 2 ranks over gloo on this card, 4 iterations with a checkpoint after "
              f"the second ({sec:.1f} s with the processes' start): {json.dumps(ring)}")
        resumed, sec = _ring("restore", ring_cfg, ckpt, 2)
        print(f"[phase 6] 2 fresh ranks restore the checkpoint and run 2 iterations: "
              f"{sec:.1f} s with the processes' start: {json.dumps(resumed)}")
        t0 = time.perf_counter()
        alone = _in_child("_restore_at_world_size_one", ckpt, ring_cfg)
        alone_sec = time.perf_counter() - t0
        raw = restore_raw(ckpt, device=dev)
    same = {k: alone["restored"]["digest"][k] == alone["single"]["digest"][k]
            for k in alone["single"]["digest"]}
    print(f"[phase 6] one child process restores the 2-rank checkpoint at world size 1 over NCCL "
          f"and runs 2 iterations, against the single-device train_step from restore_raw's "
          f"carry with rank 0's generators ({alone_sec:.1f} s with the process's start): "
          f"bit-identical {json.dumps(same)}; batch, K2 launches per iteration "
          f"{json.dumps({k: (v['batch'], v['launches']) for k, v in alone.items()})}")
    if not all(same.values()):
        raise AssertionError(f"the world-size-1 restore differs from the single device: {same}")
    for name, run in alone.items():
        if run["batch"] != PPO_B or run["launches"] != [cfg.rollout_len] * 2:
            raise AssertionError(f"the world-size-1 restore, {name}: batch {run['batch']}, K2 "
                                 f"launches {run['launches']}")
    if ring[0]["digest"]["params"] != ring[1]["digest"]["params"]:
        raise AssertionError("the two ranks' params differ after 4 iterations")
    for r, (a, b) in enumerate(zip(ring, resumed)):
        same = {k: a["digest"][k] == b["digest"][k] for k in a["digest"]}
        print(f"[phase 6] rank {r}: the restarted run against the uninterrupted one, "
              f"bit-identical {json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"rank {r}: the restarted run differs: {same}")
    for r in ring + resumed:
        if r["batch"] != PPO_B // 2 or r["launches"] != [cfg.rollout_len] * len(r["launches"]):
            raise AssertionError(f"rank {r['rank']}: batch {r['batch']}, K2 launches "
                                 f"{r['launches']}")
    rows = raw[2].obs.shape[0]
    print(f"[phase 6] restore_raw of the 2-rank checkpoint in this process: {rows} env rows, "
          f"{len(raw[3])} run generators, iteration {raw[4]}")
    if rows != PPO_B or len(raw[3]) != 2 or raw[4] != 2:
        raise AssertionError(f"restore_raw: {rows} rows, {len(raw[3])} generators, iteration "
                             f"{raw[4]}")
    out["ring"], out["restart_ring"], out["restart_seconds"] = ring, resumed, sec
    out["world_size_one_restore"], out["world_size_one_seconds"] = alone, alone_sec
    return out


# ---- phase 7: the convenience layer (A.19) and the left-out public
# functions (A.25), through the entry points a user calls
SQUAT_T = 3.0  # examples/simulate_anymal.py's --t-end: 1,200 steps of 2.5 ms
SQUAT_Z = (0.35, 0.65)  # m: the base neither falls nor jumps while it squats
GATE_STEPS = 25  # the squat's first steps held substep by substep
BATCH_T = 1.0  # simulate_batch: 50 control steps of 20 ms, 4 substeps each
PARITY_FIXTURE = "parity/fixtures/ball_drop_impact"
PARITY_TOL = 1e-9


def _squat_pd(motors, q0, dev):
    """examples/simulate_anymal.py's controller on (B, ·) tensors: PD (kp 80,
    kd 2) to the stand pose's joints plus a 0.5 Hz knee squat."""
    targets = q0[None, list(motors.q_idx)]
    squat_dir = torch.tensor([0.0, 1.0, -1.8] * 4, dtype=q0.dtype, device=dev)

    def pd(q, v, t):
        qm, vm = motors.joint_state(q, v)
        squat = 0.2 * torch.sin(2.0 * torch.pi * 0.5 * t)[:, None]
        return 80.0 * (targets + squat * squat_dir - qm) - 2.0 * vm

    return pd


def _batch_setup(dev):
    """(b)'s Simulator at the main path's settings, its B = 4096 seeded
    stand poses and velocities, and its batched PD."""
    from jiminy_tpu_torch.engine import EngineOptions
    from jiminy_tpu_torch.models.quadruped import anymal_hardware, anymal_urdf, stand_q
    from jiminy_tpu_torch.simulator import Simulator

    sim = Simulator.build(anymal_urdf(), anymal_hardware(), freeflyer=True, device=dev,
                          options=EngineOptions(dt=5e-3, contact_model="constraint", pgs_iters=8))
    q0 = torch.as_tensor(stand_q(sim.tree), device=dev)
    motors, nq, nv = sim.robot.motors, sim.tree.nq, sim.tree.nv
    gen = torch.Generator(device=dev).manual_seed(140)
    qb = q0.repeat(B_MAIN, 1)
    qb[:, 7:] += 0.05 * (2.0 * torch.rand(B_MAIN, nq - 7, generator=gen, device=dev) - 1.0)
    vb = 0.05 * torch.randn(B_MAIN, nv, generator=gen, device=dev)
    tgt = q0[None, list(motors.q_idx)]

    def pd(q, v, t):
        qm, vm = motors.joint_state(q, v)
        return 80.0 * (tgt - qm) - 2.0 * vm

    return sim, qb, vb, pd


def _batch_control_step_launches() -> dict:
    """GPU kernels of one ``simulate_batch`` control step with its reset
    (``torch.profiler``), after a warm-up; run in a fresh process by
    `_in_child`."""
    dev = torch.device("cuda")
    sim, qb, vb, pd = _batch_setup(dev)
    sim.simulate_batch(0.02, qb, vb, pd, control_dt=0.02)
    return _profiled_launches(lambda: sim.simulate_batch(0.02, qb, vb, pd, control_dt=0.02))


def _in_child(fn_name: str, *args) -> dict:
    """``fn_name(*args)`` of this module in a fresh Python process (the
    kernels load from their build; nothing is rebuilt); returns its JSON.
    Phase 7 profiles in one: in this process, after phases 5 and 6,
    ``torch.profiler`` has recorded no GPU kernel on the card, and an
    NCCL group alone does not do that (``tools/probe_profiler.py``).
    Phase 6 restores at world size 1 in one, a process group of its own."""
    here = str(Path(__file__).resolve().parent)
    out = subprocess.run([sys.executable, "-c", f"import json, chip_smoke as cs; "
                          f"print(json.dumps(cs.{fn_name}(*{args!r})))"],
                         cwd=here, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"{fn_name} in a child process: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_convenience(dev, path, kernels) -> dict:
    """Phase 7, the convenience layer (A.19, A.25) on the card:

    - (a) ``examples/simulate_anymal.py``'s workflow: ``Simulator.build(
      anymal_urdf(), anymal_hardware(), freeflyer=True, options=
      EngineOptions(dt=2.5e-3, contact_model="constraint", pgs_iters=8))``,
      ``simulate(3.0, q0=stand, controller=<the squat PD>)``: 1,200 engine
      steps at B = 1, exactly 1,200 K2 launches and no other; the first 25
      steps from the logged states substep by substep against the plain
      float32 and float64 paths (`_gate_vs_f64`); every column finite; the
      base height inside ``SQUAT_Z``; ``write_binary`` → ``read_binary``
      bit for bit; the robot rebuilt from the log simulates the same log
      bit for bit; ``export_html`` writes its report; the host ms per
      engine step and the share of it outside K2 (K2 timed at B = 1);
    - (b) ``simulate_batch(1.0, q0, v0, <batched PD>, control_dt=0.02)`` at
      the main path's settings, B = 4096 seeded stand poses: exactly 50 K2
      launches, the final state bit for bit a hand-written loop of
      ``Engine.step``; env-steps/s over 3 loops beside the K2 state path's
      in this call; the kernels per control step (``torch.profiler``);
    - (c) ``Engine.set_options`` on live envs: the sensor env at B = 4096
      with ``substep_fusion`` off (one step: K3 × 4, no sensor K2) and on
      again (one step: one K2 with the sensor stage); the state env with
      ``pgs_iters`` 16 bit for bit a freshly built engine's step;
      ``Engine.simulate`` on the main path's engine, one K2 per control
      step;
    - (d) ``play`` on the state env (50 steps, an HTML replay), one
      rendered frame (400, 400, 3) of the gym adapter's ``render``
      (``viewer3d.render_env``: gymnasium is not needed for it),
      ``state_flags`` clean on (b)'s states and exactly one env flagged
      after its v is set to NaN, PCG32 on the card bit for bit the CPU's,
      and ``parity.compare`` of ``ball_drop_impact`` in float64 on the
      card within 1e-9 of the CPU's report, ``ok``.

    The K2, K3 and sensor-K2 rows of ``kernels`` gain the phase's launches.
    Returns the readings."""
    import tempfile

    from jiminy_tpu_torch import parity
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.io.serialization import build_robot_from_log
    from jiminy_tpu_torch.models.quadruped import anymal_hardware, anymal_urdf, stand_q
    from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi
    from jiminy_tpu_torch.plot import export_html
    from jiminy_tpu_torch.rl.evaluate import play
    from jiminy_tpu_torch.simulator import Simulator
    from jiminy_tpu_torch.telemetry import TelemetryLog
    from jiminy_tpu_torch.utils.health import state_flags
    from jiminy_tpu_torch.utils.pcg_torch import pcg32_init, pcg32_next
    from jiminy_tpu_torch.viewer3d import render_env

    out = {}
    launched = {"substep_multi": 0, "substep": 0, "substep_multi_sensors": 0}

    def run_counted(label, fn, **expect):
        torch.cuda.synchronize()
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        path[label] = got = _counts()
        print(f"[phase 7] {label}: launches {json.dumps({n: c for n, c in got.items() if c})}")
        if got != _only(**expect):
            raise AssertionError(f"{label}: expected the launches {expect} and no other, saw {got}")
        for name in launched:
            launched[name] += got[name]
        return res

    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)

    # ---- (a) the single-robot workflow at B = 1
    opts_a = EngineOptions(dt=2.5e-3, contact_model="constraint", pgs_iters=8)
    sim = Simulator.build(anymal_urdf(), anymal_hardware(), freeflyer=True, options=opts_a,
                          device=dev)
    eng = sim.engine
    if eng.backend != "substep" or eng.nc != 24:
        raise AssertionError(f"the Simulator's engine: backend {eng.backend!r}, nc {eng.nc}")
    q0 = torch.as_tensor(stand_q(sim.tree), device=dev)
    pd = _squat_pd(sim.robot.motors, q0, dev)
    n_a = round(SQUAT_T / opts_a.dt)
    sim.simulate(0.01, q0=q0, controller=pd)  # warm-up: the first calls of every op
    t0 = time.perf_counter()
    final, log = run_counted(f"(a) Simulator.simulate, {n_a} engine steps at B=1",
                             lambda: sim.simulate(SQUAT_T, q0=q0, controller=pd),
                             substep_multi=n_a)
    wall_a = time.perf_counter() - t0
    cols = log.columns
    if len(log) != n_a or not all(np.isfinite(c).all() for c in cols.values()):
        raise AssertionError(f"(a): {len(log)} rows, finite {[k for k, c in cols.items() if not np.isfinite(c).all()]}")
    z = cols["q.2"]
    out["squat_z"] = [float(z.min()), float(z.max())]
    print(f"[phase 7] (a) base height over the squat {out['squat_z'][0]:.5f}–"
          f"{out['squat_z'][1]:.5f} m (bound {SQUAT_Z}); {len(cols)} columns, constants "
          f"{sorted(log.constants)}")
    if not (SQUAT_Z[0] < z.min() and z.max() < SQUAT_Z[1]):
        raise AssertionError(f"(a): the base left {SQUAT_Z}: {out['squat_z']}")
    # the first GATE_STEPS steps from the logged states, each from its own
    # pre-step state (λ cold), against the plain float32 and float64 paths
    nq, nv = sim.tree.nq, sim.tree.nv
    qs = torch.as_tensor(np.stack([cols[f"q.{i}"] for i in range(nq)], 1), device=dev)
    vs = torch.as_tensor(np.stack([cols[f"v.{i}"] for i in range(nv)], 1), device=dev)
    ts = torch.as_tensor(cols["time"], device=dev)
    q_in = torch.cat([q0[None], qs[:GATE_STEPS - 1]])
    v_in = torch.cat([torch.zeros_like(vs[:1]), vs[:GATE_STEPS - 1]])
    st_in = eng.reset(q_in, v_in)
    st_in.t = torch.cat([ts.new_zeros(1), ts[:GATE_STEPS - 1]])
    u_in = pd(st_in.q, st_in.v, st_in.t)
    plain = dataclasses.replace(opts_a, constraint_solver="inline")
    motors = sim.robot.motors
    eng32 = Engine(sim.tree, plain, motors=motors, device=dev)
    eng64 = Engine(sim.tree.to(dtype=torch.float64), plain,
                   motors=motors.to(dtype=torch.float64), device=dev)
    gates = _gate_substeps("(a) squat", 1, lambda s, u: eng.step(s, u),
                           lambda s, u: eng32.step(s, u), lambda s, u: eng64.step(s, u),
                           st_in, u_in)
    print(f"[phase 7] (a) the first {GATE_STEPS} steps from the logged states, K2 vs the plain "
          f"float32 and float64 paths: " + json.dumps(gates))
    log.write_binary(work / "run.jtpu")
    back = TelemetryLog.read_binary(work / "run.jtpu")
    if list(back.columns) != list(cols) or any(
            not np.array_equal(back.columns[k], cols[k]) for k in cols) \
            or back.constants != {k: str(x) for k, x in log.constants.items()}:
        raise AssertionError("(a): the binary log does not read back bit for bit")
    robot2 = build_robot_from_log(back, device=dev)
    sim2 = Simulator(robot2, options=opts_a, device=dev)
    _, log2 = sim2.simulate(SQUAT_T, q0=q0, controller=_squat_pd(robot2.motors, q0, dev))
    same = [k for k in cols if np.array_equal(log2.columns[k], cols[k])]
    if len(same) != len(cols):
        raise AssertionError(f"(a): the robot rebuilt from the log differs in "
                             f"{sorted(set(cols) - set(same))}")
    export_html(back, work / "report.html", title="ANYmal squat")
    html_bytes = (work / "report.html").stat().st_size
    sim.replay(back, work / "replay.html")
    spec = eng.substep_spec
    wrench = final.q.new_zeros(1, 6)
    u1 = pd(final.q, final.v, final.t)
    k2_ms = _time_cuda(lambda: substep_batched_multi(spec, 1, final.q, final.v, u1, final.lam,
                                                     wrench), 200)
    host_ms = 1e3 * wall_a / n_a
    out["a"] = {"host_ms_per_engine_step": host_ms, "k2_ms_at_b1": k2_ms,
                "share_outside_k2": 1.0 - k2_ms / host_ms, "wall_s": wall_a,
                "html_bytes": html_bytes}
    print(f"[phase 7] (a) {n_a} engine steps in {wall_a:.3f} s: {host_ms:.4f} ms of host time "
          f"per engine step, K2 alone {k2_ms:.4f} ms at B=1 ({out['a']['share_outside_k2']:.3f} "
          f"of the step outside K2); the log read back bit for bit; the rebuilt robot's run "
          f"bit for bit the first's ({len(cols)} columns); report {html_bytes} bytes")

    # ---- (b) simulate_batch at the main path's settings, B = 4096
    sim_b, qb, vb, pd_b = _batch_setup(dev)
    eng_b = sim_b.engine
    n_b = round(BATCH_T / 0.02)
    sim_b.simulate_batch(0.02, qb, vb, pd_b, control_dt=0.02)  # warm-up
    fin_b = run_counted(f"(b) simulate_batch, {n_b} control steps of 4 substeps at B={B_MAIN}",
                        lambda: sim_b.simulate_batch(BATCH_T, qb, vb, pd_b, control_dt=0.02),
                        substep_multi=n_b)
    st = eng_b.reset(qb, vb)
    for _ in range(n_b):
        st = eng_b.step(st, pd_b(st.q, st.v, st.t), n_substeps=4)
    diff = [f for f in ("t", "q", "v", "lam", "contact_forces", "solver_residual")
            if not torch.equal(getattr(st, f), getattr(fin_b, f))]
    if diff:
        raise AssertionError(f"(b): simulate_batch differs from the Engine.step loop in {diff}")
    rates_b = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim_b.simulate_batch(BATCH_T, qb, vb, pd_b, control_dt=0.02)
        torch.cuda.synchronize()
        rates_b.append(B_MAIN * n_b / (time.perf_counter() - t0))
    env = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    act_gen = torch.Generator(device=dev).manual_seed(141)
    st_e = env.reset(torch.Generator(device=dev).manual_seed(142), B_MAIN)
    for _ in range(5):  # warm-up
        st_e = env.step(st_e, _uniform(act_gen, dev))
    rates_k2, st_e = _env_rate(env, st_e, act_gen, dev, STEPS, 3)
    prof = _in_child("_batch_control_step_launches")
    flags = state_flags(fin_b)
    out["b"] = {"env_steps_per_s": rates_b, "k2_state_path_env_steps_per_s": rates_k2,
                "kernels_per_control_step": prof}
    print(f"[phase 7] (b) the final state bit for bit the Engine.step loop's; env-steps/s "
          f"{[round(r, 1) for r in rates_b]} (max {max(rates_b):.1f}) against the K2 state "
          f"path's {[round(r, 1) for r in rates_k2]} (max {max(rates_k2):.1f}; "
          f"{max(rates_b) / max(rates_k2):.3f}×); GPU kernels of one control step with its "
          f"reset (torch.profiler) {json.dumps(prof)}")
    if prof["substep"] != 1 or prof["k1"]:
        raise AssertionError(f"(b) under the profiler: {prof}")

    # ---- (c) Engine.set_options on live envs
    env_s = ANYmalEnv(device=dev, **SENSOR_KW)
    st_s = env_s.reset(torch.Generator(device=dev).manual_seed(143), B_MAIN)
    env_s.engine.set_options({"substep_fusion": False})
    if env_s._fused_sensors:
        raise AssertionError("(c): the sensor env still takes the fused path without fusion")
    st_s = run_counted("(c) sensor env step, substep_fusion=False",
                       lambda: env_s.step(st_s, _uniform(act_gen, dev)), substep=4)
    env_s.engine.set_options({"substep_fusion": True})
    if not env_s._fused_sensors:
        raise AssertionError("(c): the sensor env does not take the fused path again")
    st_s = run_counted("(c) sensor env step, substep_fusion=True again",
                       lambda: env_s.step(st_s, _uniform(act_gen, dev)), substep_multi_sensors=1)
    _check_finite(st_s, "(c) the sensor env")
    env.engine.set_options({"pgs_iters": 16})
    fresh = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=16, device=dev).engine
    u_e = env._action_to_command(_uniform(act_gen, dev), st_e.sim)
    a_, b_ = env.engine.step(st_e.sim, u_e, n_substeps=4), fresh.step(st_e.sim, u_e, n_substeps=4)
    diff = [f for f in ("q", "v", "lam") if not torch.equal(getattr(a_, f), getattr(b_, f))]
    if env.engine.substep_spec.cfg.iters != 16 or diff:
        raise AssertionError(f"(c): set_options(pgs_iters=16) differs from a fresh engine in {diff}")
    env.engine.set_options({"pgs_iters": 8})
    hold = env._stand_targets.expand(B_MAIN, -1).contiguous()  # the kernels take dense rows
    _, traj = run_counted("(c) Engine.simulate on the main path's engine, 5 control steps",
                          lambda: env.engine.simulate(st_e.sim, 0.1, lambda q, v, t: hold,
                                                      control_dt=0.02), substep_multi=5)
    if traj["q"].shape != (5, B_MAIN, nq) or not np.isfinite(traj["q"]).all():
        raise AssertionError(f"(c): Engine.simulate's log {traj['q'].shape}")
    print("[phase 7] (c) set_options: the unfused sensor step ran K3 × 4, the fused one K2 "
          "with its sensor stage; pgs_iters 16 bit for bit a fresh engine's step")

    # ---- (d) play, render, health, PCG32, parity
    qs_p, rewards = run_counted("(d) play, 50 steps", lambda: play(
        ANYmalEnv(observe="state", device=dev), n_steps=50,
        replay_path=work / "play.html"), substep_multi=50)
    if qs_p.shape != (26, nq) or rewards.shape != (50,) or not np.isfinite(rewards).all():
        raise AssertionError(f"(d) play: qs {qs_p.shape}, rewards {rewards.shape}")
    frame = render_env(env, st_e)
    if frame.shape != (400, 400, 3) or frame.dtype != np.uint8 or frame.std() == 0:
        raise AssertionError(f"(d) render: {frame.shape} {frame.dtype}")
    if bool((flags != 0).any()):
        raise AssertionError(f"(d) state_flags on (b)'s final states: {int((flags != 0).sum())}")
    bad_v = fin_b.v.clone()
    bad_v[7, 3] = float("nan")
    bad = state_flags(dataclasses.replace(fin_b, v=bad_v))
    if (bad != 0).nonzero().flatten().tolist() != [7]:
        raise AssertionError(f"(d) state_flags after one NaN: {(bad != 0).nonzero().flatten()}")
    seeds = torch.arange(B_MAIN, dtype=torch.int64)
    draws = []
    for where in (dev, torch.device("cpu")):
        st_pcg, xs = pcg32_init(seeds.to(where), device=where), []
        for _ in range(16):
            st_pcg, x = pcg32_next(st_pcg)
            xs.append(x)
        draws.append(torch.stack(xs).cpu())
    if not torch.equal(*draws):
        raise AssertionError("(d) PCG32 on the card differs from the CPU's")
    reports = {where: parity.compare(PARITY_FIXTURE, device=where) for where in (dev, "cpu")}
    rc, rh = reports[dev], reports["cpu"]
    gap = max(abs(rc.max_drift_q - rh.max_drift_q), abs(rc.max_drift_v - rh.max_drift_v))
    out["d"] = {"play_return": float(rewards.sum()), "frame_mean": float(frame.mean()),
                "parity_card": dataclasses.asdict(rc), "parity_cpu": dataclasses.asdict(rh),
                "parity_gap": gap}
    print(f"[phase 7] (d) play {len(rewards)} steps, return {rewards.sum():.4f}; frame "
          f"{frame.shape} mean {frame.mean():.2f}; state_flags clean, one NaN flags env 7 "
          f"alone; PCG32 {tuple(draws[1].shape)} draws bit for bit; parity "
          f"{rc.json()} against the CPU's {rh.json()}: gap {gap:.3g} (bound {PARITY_TOL})")
    if not (rc.ok and rh.ok) or gap > PARITY_TOL or rc.device != str(dev):
        raise AssertionError(f"(d) parity on the card: {rc} against {rh}")
    tmp.cleanup()

    for row in kernels:
        if row["name"] in launched:
            row["launches"] += launched[row["name"]]
    out["launches"] = launched
    print(f"[phase 7] launches of the phase, added to the kernels line's rows: "
          f"{json.dumps(launched)}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU available")
    run(torch.device("cuda"))


def run(dev) -> None:
    """Every phase on ``dev`` (the card; ``main`` refuses to start
    without one)."""
    _CLOCK["start"] = _CLOCK["last"] = time.perf_counter()
    gpu = _gpu_line()
    print(f"[phase 0] {gpu}")
    print(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from jiminy_tpu_torch.envs import ANYmalEnv, CassieEnv
    from jiminy_tpu_torch.ops import _build
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched, solve_reference
    from jiminy_tpu_torch.ops.substep_kernel import (
        substep_batched,
        substep_batched_multi,
        substep_multi_reference,
        substep_reference,
        unpack_model_params,
    )

    t0 = time.perf_counter()
    build = _build.build_all()
    print(f"[phase 0] nvcc build {json.dumps(build)} "
          f"wall {time.perf_counter() - t0:.2f} s")
    for name in sorted(build):
        for line in _build.ptxas_report(name):
            print(f"[phase 0] {name}: {line}")
    _warp_report(dev)
    _lap("phase 0: the build and the layouts")

    # ---- phase 1: every kernel against its plain version
    main_err = {"constraint_solve": phase_kernel_vs_plain(dev)}
    main_err.update(phase_substep_vs_plain(dev))
    main_err["substep_multi_sensors"] = phase_sensors_vs_plain(dev)
    main_err.update(phase_ground_vs_plain(dev))
    main_err.update(phase_rand_vs_plain(dev))
    _lap("phase 1: the ANYmal kernels against their plain versions")

    # ---- phase 2: the paths through the public entry points
    kw = dict(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    env = ANYmalEnv(**kw)
    if env.engine.backend != "substep":
        raise AssertionError("the env's default is not the whole-substep kernel")
    act_gen = torch.Generator(device=dev).manual_seed(1)
    path = {}  # each path's launches

    def drive(label, env_, seed, steps, **expect):
        """``steps`` env steps from a fresh batch with the counts set to 0
        just before and read just after; raises unless exactly
        ``expect`` launched and the state is finite."""
        st = env_.reset(torch.Generator(device=dev).manual_seed(seed), B_MAIN)
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(steps):
            st = env_.step(st, _uniform(act_gen, dev, env_.motors.nm))
        torch.cuda.synchronize()
        path[label] = got = _counts()
        warp = _check_warp(label, env_.engine.substep_spec, got)
        print(f"[phase 2] {label}, {steps} env steps at B={B_MAIN}: launches "
              f"{json.dumps({n: c for n, c in got.items() if c})} (the warp body {warp})")
        if got != _only(**expect):
            raise AssertionError(f"{label}: expected the launches {expect} and no other, saw {got}")
        _check_finite(st, label)
        print(f"[phase 2] {label}: finite q, v, obs, reward; done this step "
              f"{int(st.done.sum())}/{B_MAIN}; mean reward {st.reward.mean().item():.4f}")
        return st

    def drive_unfused(label, eng, model_params=None, walker=None, start=None, **expect):
        """3 env steps of an engine with ``substep_fusion=False`` (K3,
        one launch per substep) from the state ``start`` of the env
        ``walker`` (the main path's by default), with each env's
        ``model_params`` when given."""
        walker = walker or env
        sim = (start or state).sim
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(3):
            u = walker._action_to_command(_uniform(act_gen, dev, walker.motors.nm), sim)
            sim = eng.step(sim, u, n_substeps=walker.n_substeps, model_params=model_params)
        torch.cuda.synchronize()
        path[label] = got = _counts()
        warp = _check_warp(label, eng.substep_spec, got)
        print(f"[phase 2] {label}, 3 env steps: launches "
              f"{json.dumps({n: c for n, c in got.items() if c})} (the warp body {warp})")
        if got != _only(**expect):
            raise AssertionError(f"{label}: expected the launches {expect} and no other, saw {got}")
        if not (bool(torch.isfinite(sim.q).all()) and bool(torch.isfinite(sim.v).all())):
            raise AssertionError(f"non-finite state on the {label} path")

    state = drive("main path", env, 0, STEPS, substep_multi=STEPS)
    _ab_env_step(env, state, act_gen, dev)

    env_k1 = ANYmalEnv(constraint_solver="kernel", **kw)
    state_k1 = drive("constraint_solver='kernel'", env_k1, 4, 3, constraint_solve=12)
    eng_k3 = _anymal_engine(dev, residual=False, fusion=False)
    drive_unfused("substep_fusion=False", eng_k3, substep=12)

    env_s = ANYmalEnv(device=dev, **SENSOR_KW)
    if not env_s._fused_sensors:
        raise AssertionError("the sensor env does not take the fused sensor path")
    state_s = drive("sensor path", env_s, 6, STEPS, substep_multi_sensors=STEPS)
    if state_s.obs.shape != (B_MAIN, 33):
        raise AssertionError(f"sensor obs of shape {tuple(state_s.obs.shape)}")
    _ab_sensor_step(env_s, state_s, act_gen, dev)

    # the slice's path: per-env Fourier terrain, pushes, sensors
    env_t = ANYmalEnv(device=dev, **TERRAIN_KW)
    if not (env_t._fused_sensors and env_t.engine.substep_spec.ground_mode == "fourier"):
        raise AssertionError("the terrain env does not take the fused ground path")
    state_t = drive("terrain path (fourier, pushes, sensors)", env_t, 8, STEPS,
                    substep_multi_sensors_ground=STEPS)
    pushed = int((state_t.info["push_steps_left"] > 0).sum())
    h, _ = env_t._episode_ground(state_t.info).query(state_t.sim.q[:, :2])
    print(f"[phase 2] terrain path: {pushed}/{B_MAIN} envs being pushed; base height above "
          f"each env's own ground {(state_t.sim.q[:, 2] - h).mean().item():.4f} m (mean)")
    _ab_sensor_step(env_t, state_t, act_gen, dev, TERRAIN_KW, fused="substep_multi_sensors_ground",
                    chunked="substep_multi_ground", label="terrain path")
    env_p = ANYmalEnv(terrain="perlin", push_magnitude=6.0, **kw)
    drive("perlin terrain with pushes, state path", env_p, 9, 10, substep_multi_ground=10)
    env_g = ANYmalEnv(terrain="perlin_grid", **kw)
    if env_g.engine.backend != "kernel":
        raise AssertionError("perlin_grid does not resolve to the chain kernel")
    drive("perlin_grid heightmap", env_g, 10, 3, constraint_solve=12)
    eng_k3s = _anymal_engine(dev, residual=False, fusion=False, ground=_ground_template("stairs", dev))
    drive_unfused("stairs, substep_fusion=False", eng_k3s, substep_ground=12)

    # the slice's path: the terrain path with per-episode model randomization
    SIM2REAL_KW = dict(TERRAIN_KW, model_randomization=_randomization())
    env_r = ANYmalEnv(device=dev, **SIM2REAL_KW)
    if not (env_r._fused_sensors and env_r.engine.substep_spec.ground_mode == "fourier"):
        raise AssertionError("the sim-to-real env does not take the fused ground path")
    state_r = drive("sim-to-real path (randomized, fourier, pushes, sensors)", env_r, 12, STEPS,
                    rand_substep_multi_sensors_ground=STEPS)
    inertials, (gain, _) = unpack_model_params(env_r.engine.substep_spec,
                                               env_r._model_params(state_r.info))
    m0 = env_r.tree.inertia_mass
    mscale = inertials.mass[:, m0 > 0] / m0[m0 > 0]
    print(f"[phase 2] sim-to-real path: info['model_params'] {tuple(state_r.info['model_params'].shape)}, "
          f"mass scales {mscale.min().item():.4f}–{mscale.max().item():.4f}, motor "
          f"gains {gain.min().item():.4f}–{gain.max().item():.4f}")
    # where an episode ends the auto-reset draws fresh parameters: env 0
    # sent below its ground, the others left as they are
    q_low = state_r.sim.q.clone()
    q_low[0, 2] = -1.0
    low = state_r.replace(sim=dataclasses.replace(state_r.sim, q=q_low))
    nxt = env_r.step(low, _uniform(act_gen, dev))
    changed = (nxt.info["model_params"] != low.info["model_params"]).any(dim=1)
    if not (bool(nxt.done[0]) and torch.equal(changed, nxt.done)):
        raise AssertionError(f"the auto-reset did not redraw exactly the finished envs' parameters: "
                             f"{int(changed.sum())} changed, {int(nxt.done.sum())} done")
    print(f"[phase 2] sim-to-real path: the auto-reset redrew the parameters of exactly the "
          f"{int(nxt.done.sum())} finished envs")
    _ab_sensor_step(env_r, state_r, act_gen, dev, SIM2REAL_KW,
                    fused="rand_substep_multi_sensors_ground",
                    chunked="rand_substep_multi_ground", label="sim-to-real path")
    # each other randomized instantiation through a path that runs it
    drive("randomized state path", ANYmalEnv(model_randomization=_randomization(), **kw), 13, 10,
          rand_substep_multi=10)
    drive("randomized sensor path", ANYmalEnv(model_randomization=_randomization(), device=dev,
                                              **SENSOR_KW), 14, 10, rand_substep_multi_sensors=10)
    drive("randomized perlin terrain, state path",
          ANYmalEnv(terrain="perlin", push_magnitude=6.0, model_randomization=_randomization(),
                    **kw), 15, 10, rand_substep_multi_ground=10)
    mp_k3 = eng_k3._pack_model_params(_randomization().sample(
        torch.Generator(device=dev).manual_seed(16), eng_k3.tree, eng_k3.motors, B_MAIN))
    drive_unfused("randomized, substep_fusion=False", eng_k3, mp_k3, rand_substep=12)
    drive_unfused("randomized stairs, substep_fusion=False", eng_k3s, mp_k3, rand_substep_ground=12)

    _lap("phase 2: the ANYmal paths")
    # ---- phase 3: times
    for _ in range(STEPS):  # warm-up
        state = env.step(state, _uniform(act_gen, dev))
    rates, state = _env_rate(env, state, act_gen, dev, STEPS, 3)
    print(f"[phase 3] env-steps/s at B={B_MAIN}, main path (K2): {[round(r, 1) for r in rates]} "
          f"(max {max(rates):.1f})")
    for _ in range(5):  # warm-up
        state_s = env_s.step(state_s, _uniform(act_gen, dev))
    rates_s, _ = _env_rate(env_s, state_s, act_gen, dev, STEPS, 3)
    print(f"[phase 3] env-steps/s at B={B_MAIN}, sensor path (K2 with the sensor stage): "
          f"{[round(r, 1) for r in rates_s]} (max {max(rates_s):.1f})")
    for _ in range(5):  # warm-up
        state_t = env_t.step(state_t, _uniform(act_gen, dev))
    rates_t, _ = _env_rate(env_t, state_t, act_gen, dev, STEPS, 3)
    print(f"[phase 3] env-steps/s at B={B_MAIN}, terrain path (K2 with the sensor stage and the "
          f"ground query): {[round(r, 1) for r in rates_t]} (max {max(rates_t):.1f}; "
          f"{max(rates_t) / max(rates_s):.3f}× the sensor path's)")
    for _ in range(5):  # warm-up
        state_r = env_r.step(state_r, _uniform(act_gen, dev))
    rates_r, _ = _env_rate(env_r, state_r, act_gen, dev, STEPS, 3)
    print(f"[phase 3] env-steps/s at B={B_MAIN}, sim-to-real path (the randomized K2 with the "
          f"sensor stage and the ground query): {[round(r, 1) for r in rates_r]} (max "
          f"{max(rates_r):.1f}; {max(rates_r) / max(rates_t):.3f}× the terrain path's)")
    state_k1 = env_k1.step(state_k1, _uniform(act_gen, dev))  # warm-up
    before = _counts()
    rates_k1, _ = _env_rate(env_k1, state_k1, act_gen, dev, 5, 2)
    launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
    print(f"[phase 3] env-steps/s at B={B_MAIN}, constraint_solver='kernel' (K1): "
          f"{[round(r, 1) for r in rates_k1]}; launches in the 10 timed steps {json.dumps(launched)}")
    if launched != {"constraint_solve": 40}:
        raise AssertionError(f"the 'kernel' path, timed: {launched} in 10 env steps")
    eng_k3.step(state.sim, env._action_to_command(_uniform(act_gen, dev), state.sim),
                n_substeps=env.n_substeps)  # warm-up
    rates_k3, launched = _engine_rate(eng_k3, env, state.sim, act_gen, dev, 10, 3)
    print(f"[phase 3] env-steps/s at B={B_MAIN}, substep_fusion=False (K3, 4 launches per env "
          f"step): {[round(r, 1) for r in rates_k3]}; launches in the 30 timed steps "
          f"{json.dumps(launched)}")
    if launched != {"substep": 120}:
        raise AssertionError(f"the unfused path, timed: {launched} in 30 env steps")

    kernels = []

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def entry(name, source, replaces, launched, ms, plain_ms, n_bytes, n_ops):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"[phase 3] {name} B={B_MAIN}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({n_bytes} B, {n_ops} FLOP)")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": main_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes these functions
        })

    spec = eng_k3.substep_spec
    q, v, cmd, lam0, wrench = _substep_inputs(eng_k3, torch.Generator(device=dev).manual_seed(5), B_MAIN)
    tau = eng_k3._joint_torque(cmd, q, v)
    n_sub = env.n_substeps
    k2_ops = B_MAIN * (n_sub * (_substep_flops(spec) + _torque_flops(spec)) + 2 * spec.tree.nv)
    entry(
        "substep_multi", WARP_SOURCE,
        "jiminy_tpu/ops/substep_kernel.py:1815", path["main path"]["substep_multi"],
        _time_cuda(lambda: substep_batched_multi(spec, n_sub, q, v, cmd, lam0, wrench), 20),
        _time_cuda(lambda: substep_multi_reference(spec, n_sub, q, v, cmd, lam0, wrench), 3),
        _substep_multi_bytes(spec, B_MAIN), k2_ops,
    )
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    sens = SensorKernelSpec(eng_k3.tree, _anymal_suite(dev), env_s.n_substeps_per_obs)
    n_upd = n_sub // sens.k_obs
    _, _, _, _, _, bufs, eps = _sensor_inputs(eng_k3, sens, torch.Generator(device=dev).manual_seed(7),
                                              B_MAIN, n_upd)
    sw = dict(sensors=sens, bufs=bufs, eps=eps)
    sens_bytes = _sensor_bytes(sens, B_MAIN, n_upd)
    sens_ops = B_MAIN * n_upd * _sensor_flops(spec, sens)

    def sensor_k2():
        return substep_batched_multi(spec, n_sub, q, v, cmd, lam0, wrench, **sw)

    sensor_k2_ms = _time_cuda(sensor_k2, 20)
    entry(
        "substep_multi_sensors", WARP_SOURCE,
        "jiminy_tpu/ops/substep_kernel.py:1459", path["sensor path"]["substep_multi_sensors"],
        sensor_k2_ms,
        _time_cuda(lambda: substep_multi_reference(spec, n_sub, q, v, cmd, lam0, wrench, **sw), 3),
        _substep_multi_bytes(spec, B_MAIN) + sens_bytes, k2_ops + sens_ops,
    )
    entry(
        "substep", WARP_SOURCE,
        "jiminy_tpu/ops/substep_kernel.py:1678", path["substep_fusion=False"]["substep"],
        _time_cuda(lambda: substep_batched(spec, q, v, tau, lam0, wrench), 20),
        _time_cuda(lambda: substep_reference(spec, q, v, tau, lam0, wrench), 3),
        _substep_bytes(spec, B_MAIN), B_MAIN * _substep_flops(spec),
    )
    cfg = env_k1.engine.substep_spec.cfg
    args = _rand_system(torch.Generator(device=dev).manual_seed(2), B_MAIN, cfg.n, cfg.nc, dev)
    entry(
        "constraint_solve", "jiminy_tpu_torch/csrc/constraint_solve.cu",
        "jiminy_tpu/ops/constraint_solve.py:358", path["constraint_solver='kernel'"]["constraint_solve"],
        _time_cuda(lambda: solve_batched(cfg, *args, device=dev), 50),
        _time_cuda(lambda: solve_reference(cfg, *args), 5),
        _solve_bytes(cfg, B_MAIN), _solve_flops(cfg) * B_MAIN,
    )

    # the ground instantiations on each ground (B.4), from the inputs of
    # phase 1: the slice's Fourier ground enters the kernels line, each
    # instantiation with the launches of the path that runs it
    json_ground = {"substep_multi_sensors_ground": ("fourier", "terrain path (fourier, pushes, sensors)"),
                   "substep_multi_ground": ("perlin", "perlin terrain with pushes, state path"),
                   "substep_ground": ("stairs", "stairs, substep_fusion=False")}
    for kind in GROUND_KINDS:
        geng = _anymal_engine(dev, residual=False, fusion=False, ground=_ground_template(kind, dev))
        gspec = geng.substep_spec
        gargs, gc, _ = _ground_inputs(geng, kind, torch.Generator(device=dev).manual_seed(11), B_MAIN)
        gq, gv, gcmd, glam0, gwrench = gargs
        gtau = geng._joint_torque(gcmd, gq, gv)
        gc_bytes = 4 * gc.numel()
        g_ops = B_MAIN * _ground_flops(gspec)
        print(f"[phase 3] {kind} ground: {_ground_query_flops(gspec)} FLOP per query, "
              f"{_ground_flops(gspec)} per env per substep beyond the flat substep's "
              f"{_substep_flops(gspec)}")
        runs = {
            "substep_multi_sensors_ground": (
                lambda: substep_batched_multi(gspec, n_sub, *gargs, gc=gc, **sw),
                lambda: substep_multi_reference(gspec, n_sub, *gargs, gc=gc, **sw),
                _substep_multi_bytes(gspec, B_MAIN) + sens_bytes + gc_bytes,
                k2_ops + sens_ops + n_sub * g_ops),
            "substep_multi_ground": (
                lambda: substep_batched_multi(gspec, n_sub, *gargs, gc=gc),
                lambda: substep_multi_reference(gspec, n_sub, *gargs, gc=gc),
                _substep_multi_bytes(gspec, B_MAIN) + gc_bytes, k2_ops + n_sub * g_ops),
            "substep_ground": (
                lambda: substep_batched(gspec, gq, gv, gtau, glam0, gwrench, gc=gc),
                lambda: substep_reference(gspec, gq, gv, gtau, glam0, gwrench, gc=gc),
                _substep_bytes(gspec, B_MAIN) + gc_bytes, B_MAIN * (_substep_flops(gspec) + _ground_flops(gspec))),
        }
        for name, (kernel, plain, n_bytes, n_ops) in runs.items():
            ms, plain_ms = _time_cuda(kernel, 20), _time_cuda(plain, 3)
            in_json = json_ground[name][0] == kind
            if in_json:
                entry(name, WARP_SOURCE,
                      "jiminy_tpu/ops/substep_kernel.py:1219", path[json_ground[name][1]][name],
                      ms, plain_ms, n_bytes, n_ops)
            else:
                bound_ms, bound_by = bound(n_bytes, n_ops)
                print(f"[phase 3] {name} on the {kind} ground B={B_MAIN}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
                      f"{n_bytes} B, {n_ops} FLOP)")

    # the randomized instantiations (B.5), on phase 1's inputs with each
    # env's parameters: flat, and on the slice's Fourier ground
    rgen = torch.Generator(device=dev).manual_seed(17)
    for kind in ("flat", "fourier"):
        reng = _anymal_engine(dev, residual=False, fusion=False,
                              ground=_ground_template(kind, dev) if kind != "flat" else None)
        rspec = reng.substep_spec
        if kind == "flat":
            rargs, rgc, sfx, g_bytes, g_ops = _substep_inputs(reng, rgen, B_MAIN), None, "", 0, 0
        else:
            rargs, rgc, _ = _ground_inputs(reng, kind, rgen, B_MAIN)
            sfx, g_bytes, g_ops = "_ground", 4 * rgc.numel(), B_MAIN * _ground_flops(rspec)
        rq, rv, rcmd, rlam0, rwrench = rargs
        mp = _rand_params(reng, rgen, B_MAIN)
        rtau = reng._joint_torque(rcmd, rq, rv, unpack_model_params(rspec, mp)[1])
        mp_bytes = 4 * mp.numel()
        rand_ops = B_MAIN * n_sub * _rand_flops(rspec)
        launched_by = {"rand_substep_multi_sensors_ground":
                       "sim-to-real path (randomized, fourier, pushes, sensors)",
                       "rand_substep_multi_ground": "randomized perlin terrain, state path",
                       "rand_substep_ground": "randomized stairs, substep_fusion=False",
                       "rand_substep_multi": "randomized state path",
                       "rand_substep_multi_sensors": "randomized sensor path",
                       "rand_substep": "randomized, substep_fusion=False"}
        runs = {
            "rand_substep_multi_sensors" + sfx: (
                lambda: substep_batched_multi(rspec, n_sub, *rargs, gc=rgc, mp=mp, **sw),
                lambda: substep_multi_reference(rspec, n_sub, *rargs, gc=rgc, mp=mp, **sw),
                _substep_multi_bytes(rspec, B_MAIN) + sens_bytes + g_bytes + mp_bytes,
                k2_ops + sens_ops + n_sub * g_ops + rand_ops),
            "rand_substep_multi" + sfx: (
                lambda: substep_batched_multi(rspec, n_sub, *rargs, gc=rgc, mp=mp),
                lambda: substep_multi_reference(rspec, n_sub, *rargs, gc=rgc, mp=mp),
                _substep_multi_bytes(rspec, B_MAIN) + g_bytes + mp_bytes,
                k2_ops + n_sub * g_ops + rand_ops),
            "rand_substep" + sfx: (
                lambda: substep_batched(rspec, rq, rv, rtau, rlam0, rwrench, gc=rgc, mp=mp),
                lambda: substep_reference(rspec, rq, rv, rtau, rlam0, rwrench, gc=rgc, mp=mp),
                _substep_bytes(rspec, B_MAIN) + g_bytes + mp_bytes,
                B_MAIN * _substep_flops(rspec) + g_ops),
        }
        for name, (kernel, plain, n_bytes, n_ops) in runs.items():
            ms, plain_ms = _time_cuda(kernel, 20), _time_cuda(plain, 3)
            entry(name, WARP_SOURCE,
                  "jiminy_tpu/ops/substep_kernel.py:507", path[launched_by[name]][name],
                  ms, plain_ms, n_bytes, n_ops)

    _lap("phase 3: the ANYmal rates and kernel times")
    # ---- A.15 with B.10 in the ANYmal frame, before any large-frame launch:
    # the cartpole's kernels and engine paths, then the Ant and Spotmicro env
    # paths and their numbers
    main_err.update(phase_prismatic_vs_plain(dev, ("cartpole",)))
    path["cartpole engine path"], sim_cp, eng_cp = _prismatic_path(dev, "cartpole", 5)
    x = sim_cp.q[:, 0].abs()
    print(f"[phase 2] cartpole engine path, 5 steps of {CARTPOLE_SUBSTEPS} substeps at "
          f"B={B_MAIN} (the motor at 30 N toward the nearer limit): launches "
          f"{json.dumps({n: c for n, c in path['cartpole engine path'].items() if c})}; share of "
          f"envs at the ±{CART_LIMIT} m limit {float((x > CART_LIMIT - 1e-3).double().mean()):.4f},"
          f" largest |x| {x.max().item():.5f} m")
    if path["cartpole engine path"] != _only(substep_multi=5) or x.max().item() > CART_LIMIT + 0.003:
        raise AssertionError(f"cartpole engine path: launches {path['cartpole engine path']}, "
                             f"largest |x| {x.max().item()} past the limit's 2 mm of the inputs")
    path["cartpole substep_fusion=False"] = _prismatic_path(dev, "cartpole", 3, fusion=False)[0]
    if path["cartpole substep_fusion=False"] != _only(substep=3 * CARTPOLE_SUBSTEPS):
        raise AssertionError(f"cartpole unfused: {path['cartpole substep_fusion=False']}")

    walkers = {}
    for wi, wname in enumerate(WALKERS):
        for obs in ("state", "sensors"):
            env_w = _walker_env(wname, dev, observe=obs)
            label = f"{wname} {obs} path"
            if env_w.engine.backend != "substep" or (obs == "sensors") != env_w._fused_sensors:
                raise AssertionError(f"{label}: not the whole-substep kernel's fused path")
            counter = "substep_multi" if obs == "state" else "substep_multi_sensors"
            st = drive(label, env_w, 50 + 2 * wi + (obs == "sensors"), STEPS, **{counter: STEPS})
            t = env_w.tree
            print(f"[phase 2] {label}: nb {t.nb}, nq {t.nq}, nv {t.nv}, nc {env_w.engine.nc}, "
                  f"{env_w.n_substeps} substeps per env step, k_obs "
                  f"{env_w.n_substeps_per_obs}; obs {tuple(st.obs.shape)}; base height mean "
                  f"{st.sim.q[:, 2].mean().item():.4f} m")
            if obs == "state":
                _ab_walker_substeps(env_w, st, act_gen, dev, dict(observe="state"), label)
            else:
                # fused against chunked held; over the 20 substeps the distance
                # to the f64 env is reported only (float32 compounds, ROADMAP C.2)
                _ab_sensor_step(env_w, st, act_gen, dev, dict(observe="sensors"), label=label,
                                gate=functools.partial(_gate_dist_vs_f64, check=False))
            walkers[(wname, obs)] = (env_w, st)

    rates_w = {}
    for (wname, obs), (env_w, st) in walkers.items():
        for _ in range(5):  # warm-up
            st = env_w.step(st, _uniform(act_gen, dev, env_w.motors.nm))
        torch.cuda.synchronize()
        _reset_counts()
        rates_w[f"{wname} {obs}"], st = _env_rate(env_w, st, act_gen, dev, STEPS, 3)
        launched = {n: c for n, c in _counts().items() if c}
        _check_warp(f"{wname} {obs} path, timed", env_w.engine.substep_spec, launched)
        print(f"[phase 3] env-steps/s at B={B_MAIN}, {wname} {obs} path: "
              f"{[round(r, 1) for r in rates_w[f'{wname} {obs}']]} (max "
              f"{max(rates_w[f'{wname} {obs}']):.1f}); launches in the {3 * STEPS} timed steps "
              f"{json.dumps(launched)}")
        counter = "substep_multi" if obs == "state" else "substep_multi_sensors"
        if launched != {counter: 3 * STEPS}:
            raise AssertionError(f"{wname} {obs} path: {launched} in {3 * STEPS} env steps")
        walkers[(wname, obs)] = (env_w, st)

    k2_entry = "jiminy_tpu/ops/substep_kernel.py:1815"
    for wname in WALKERS:
        env_w, st = walkers[(wname, "state")]
        env_ws = walkers[(wname, "sensors")][0]
        wspec, n_w = env_w.engine.substep_spec, env_w.n_substeps
        wargs = (st.sim.q, st.sim.v, env_w._action_to_command(
            _uniform(act_gen, dev, env_w.motors.nm), st.sim), st.sim.lam,
            torch.zeros(B_MAIN, 6, device=dev))
        _k3_equals_k2(wname, wspec, wargs)
        wsens = SensorKernelSpec(env_w.tree, env_ws.sensors, env_ws.n_substeps_per_obs)
        k_obs, suite = wsens.k_obs, env_ws.sensors
        wgen = torch.Generator(device=dev).manual_seed(60)
        wbufs = suite.flatten_buffers(suite.reset(suite.sample_eps(wgen, B_MAIN), *wargs[:2]))
        wsw = dict(sensors=wsens, bufs=wbufs, eps=torch.cat(
            [suite.sample_eps(wgen, B_MAIN) for _ in range(n_w // k_obs)], 1))
        # the sensor stage's first update (n_sub = k_obs) against the plain
        # version in float32 and float64 from this rollout state
        spec64 = _walker_env(wname, dev, observe="sensors", dtype=torch.float64).engine.substep_spec
        sens64 = SensorKernelSpec(spec64.tree, suite.to(dtype=torch.float64), k_obs)
        one = dict(sensors=wsens, bufs=wbufs, eps=wsw["eps"][:, :wsens.n_eps].contiguous())
        k = substep_batched_multi(wspec, k_obs, *wargs, **one)
        p32 = substep_multi_reference(wspec, k_obs, *wargs, **one)
        p64 = substep_multi_reference(spec64, k_obs, *(x.double() for x in wargs), sensors=sens64,
                                      bufs=wbufs.double(), eps=one["eps"].double())
        scale = _reading_scale(wsens, p64[7])
        wg = {f: _gate_vs_f64(f"{wname} K2 sensors n_sub={k_obs} {f}", k[i], p32[i], p64[i])
              for i, f in ((0, "q"), (1, "v"), (2, "lam"))}
        wg["bufs_scaled"] = _gate_vs_f64(f"{wname} K2 sensors bufs", k[7].double() / scale,
                                         p32[7].double() / scale, p64[7] / scale)
        print(f"[phase 3] {wname}: K2 with the sensor stage at n_sub={k_obs} (one update) vs the "
              f"f64 plain version: " + json.dumps(wg))
        main_err[f"{wname}_substep_multi"] = max(_max_err(k[i], p32[i]) for i in range(3))
        main_err[f"{wname}_substep_multi_sensors"] = max(
            main_err[f"{wname}_substep_multi"],
            ((k[7].double() - p32[7].double()).abs() / scale).max().item())
        w_ops = B_MAIN * (n_w * (_substep_flops(wspec) + _torque_flops(wspec)) + 2 * wspec.tree.nv)
        n_upd = n_w // k_obs
        print(f"[phase 3] {wname}: {_substep_flops(wspec)} FLOP per env per substep (chain "
              f"{_solve_flops(wspec.cfg)} at nv {wspec.tree.nv}, nc {wspec.nc}), torque "
              f"{_torque_flops(wspec)}, sensor update {_sensor_flops(wspec, wsens)}; "
              f"{n_w} substeps, {n_upd} sensor updates per env step")
        entry(
            f"{wname}_substep_multi", WARP_SOURCE, k2_entry,
            path[f"{wname} state path"]["substep_multi"],
            _time_cuda(lambda: substep_batched_multi(wspec, n_w, *wargs), 20),
            _time_cuda(lambda: substep_multi_reference(wspec, n_w, *wargs), 2),
            _substep_multi_bytes(wspec, B_MAIN), w_ops,
        )
        entry(
            f"{wname}_substep_multi_sensors", WARP_SOURCE, k2_entry,
            path[f"{wname} sensors path"]["substep_multi_sensors"],
            _time_cuda(lambda: substep_batched_multi(wspec, n_w, *wargs, **wsw), 20),
            _time_cuda(lambda: substep_multi_reference(wspec, n_w, *wargs, **wsw), 2),
            _substep_multi_bytes(wspec, B_MAIN) + _sensor_bytes(wsens, B_MAIN, n_upd),
            w_ops + B_MAIN * n_upd * _sensor_flops(wspec, wsens),
        )

    # B.10 on the cartpole: K2 over a 20 ms step and K3, from phase 1's inputs
    b10 = "jiminy_tpu/ops/substep_kernel.py:596"
    cp_spec = eng_cp.substep_spec
    cp_args = _cartpole_inputs(eng_cp, torch.Generator(device=dev).manual_seed(81), B_MAIN)
    cq, cv, ccmd, clam0, cwrench = cp_args
    cp_tau = eng_cp._joint_torque(ccmd, cq, cv)
    entry(
        "cartpole_substep_multi", WARP_SOURCE, b10,
        path["cartpole engine path"]["substep_multi"],
        _time_cuda(lambda: substep_batched_multi(cp_spec, CARTPOLE_SUBSTEPS, *cp_args), 20),
        _time_cuda(lambda: substep_multi_reference(cp_spec, CARTPOLE_SUBSTEPS, *cp_args), 2),
        _substep_multi_bytes(cp_spec, B_MAIN),
        B_MAIN * (CARTPOLE_SUBSTEPS * (_substep_flops(cp_spec) + _torque_flops(cp_spec))
                  + 2 * cp_spec.tree.nv),
    )
    entry(
        "cartpole_substep", WARP_SOURCE, b10,
        path["cartpole substep_fusion=False"]["substep"],
        _time_cuda(lambda: substep_batched(cp_spec, cq, cv, cp_tau, clam0, cwrench), 20),
        _time_cuda(lambda: substep_reference(cp_spec, cq, cv, cp_tau, clam0, cwrench), 3),
        _substep_bytes(cp_spec, B_MAIN), B_MAIN * _substep_flops(cp_spec),
    )

    _lap("phases 1-3: the cartpole, the Ant and the Spotmicro")
    # K2's warp body stage by stage (the measuring build, csrc/substep_stages.cu)
    from jiminy_tpu_torch.tools.profile_warp_stages import profile as stage_profile

    for row in stage_profile(B_MAIN, dev):
        print(f"[phase 3] K2 warp body stages, {row['model']} {row['path']} (n_sub "
              f"{row['n_sub']}): cycles per env per substep {json.dumps(row['cycles_per_env_substep'])}")

    _lap("the warp body's stages")
    # ---- Cassie and the large frame, after every ANYmal number
    main_err.update(phase_cassie_vs_plain(dev))
    # Cassie (A.12 with B.9): examples/train.py --env cassie, the large
    # frame, the pushrods and shin springs on three paths
    env_c = CassieEnv(device=dev, observe="state", **CASSIE_KW)
    if env_c.engine.backend != "substep" or env_c.engine.substep_spec.n_dist != 2:
        raise AssertionError("the Cassie env does not take the whole-substep kernel with its rods")
    state_c = drive("cassie state path", env_c, 20, STEPS, substep_multi=STEPS)
    _ab_cassie_substeps(env_c, state_c, act_gen, dev)
    rod = _rod_error(env_c, state_c.sim)
    settled = state_c.steps >= 5  # fresh episodes start with the loops open by the reset noise
    rod_max = rod[settled].max().item()
    print(f"[phase 2] cassie state path: pushrod |d − d₀| over the {int(settled.sum())} envs 5+ "
          f"steps into their episode: max {rod_max:.3g} m, mean {rod[settled].mean().item():.3g} m "
          f"(all envs: max {rod.max().item():.3g} m); base height mean "
          f"{state_c.sim.q[:, 2].mean().item():.4f} m")
    if rod_max > ROD_TOL or int(settled.sum()) < B_MAIN // 2:
        raise AssertionError(f"the pushrod loops do not hold on the card: max |d − d₀| {rod_max}")
    env_cs = CassieEnv(device=dev, **CASSIE_SENSOR_KW)
    if not env_cs._fused_sensors:
        raise AssertionError("the Cassie sensor env does not take the fused sensor path")
    state_cs = drive("cassie sensor path", env_cs, 21, STEPS, substep_multi_sensors=STEPS)
    if state_cs.obs.shape != (B_MAIN, 29):
        raise AssertionError(f"cassie sensor obs of shape {tuple(state_cs.obs.shape)}")
    # fused against chunked is held; over the env step's ten substeps the
    # distance to the f64 env is reported only (ROADMAP C.2)
    _ab_sensor_step(env_cs, state_cs, act_gen, dev, CASSIE_SENSOR_KW, label="cassie sensor path",
                    gate=functools.partial(_gate_dist_vs_f64, check=False))
    env_cp = CassieEnv(device=dev, **CASSIE_PUSH_KW)
    state_cp = drive("cassie push path", env_cp, 22, STEPS, substep_multi=STEPS)
    print(f"[phase 2] cassie push path: {int((state_cp.info['push_steps_left'] > 0).sum())}"
          f"/{B_MAIN} envs being pushed")
    drive("cassie constraint_solver='kernel'",
          CassieEnv(device=dev, observe="state", constraint_solver="kernel", **CASSIE_KW), 23, 3,
          constraint_solve=30)
    eng_ck3 = _cassie_engine(dev, residual=False, fusion=False)
    drive_unfused("cassie substep_fusion=False", eng_ck3, walker=env_c, start=state_c, substep=30)

    # the slice (A.13 with B.7): Cassie with its self-collision pairs, and
    # the other narrow phases and the sphere sites through paths that run them
    main_err.update(phase_pairs_vs_plain(dev))
    main_err.update(phase_spheres_vs_plain(dev))
    env_sc = CassieEnv(device=dev, **CASSIE_SELFCOL_KW)
    sc_spec = env_sc.engine.substep_spec
    if env_sc.engine.backend != "substep" or (sc_spec.nc, sc_spec.n_pc) != (37, 3) \
            or len(sc_spec.cfg.contact_colors) != 5:
        raise AssertionError("the self-collision env does not take the whole-substep kernel with "
                             "its 37 rows and 5 colors")
    state_sc = drive("cassie self-collision state path", env_sc, 30, STEPS, substep_multi=STEPS)
    _ab_cassie_substeps(env_sc, state_sc, act_gen, dev, CASSIE_SELFCOL_KW,
                        label="cassie self-collision state path")
    rod = _rod_error(env_sc, state_sc.sim)[state_sc.steps >= 5]
    print(f"[phase 2] cassie self-collision state path: share of envs with an active pair row "
          f"{_active_pair_share(env_sc.engine, state_sc.sim.q):.4f}; pushrod |d − d₀| max "
          f"{rod.max().item():.3g} m over the envs 5+ steps into their episode")
    if rod.max().item() > ROD_TOL:
        raise AssertionError(f"self-collision path: the pushrod loops open by {rod.max().item()}")
    env_scs = CassieEnv(device=dev, **CASSIE_SELFCOL_SENSOR_KW)
    state_scs = drive("cassie self-collision sensor path", env_scs, 31, 10,
                      substep_multi_sensors=10)
    _ab_sensor_step(env_scs, state_scs, act_gen, dev, CASSIE_SELFCOL_SENSOR_KW,
                    label="cassie self-collision sensor path",
                    gate=functools.partial(_gate_dist_vs_f64, check=False))
    env_scp = CassieEnv(device=dev, **CASSIE_SELFCOL_PUSH_KW)
    state_scp = drive("cassie self-collision push path", env_scp, 32, 10, substep_multi=10)
    eng_sck3 = _cassie_engine(dev, residual=False, fusion=False, pairs=_pair_sets()["seg"])
    drive_unfused("cassie self-collision substep_fusion=False", eng_sck3, walker=env_sc,
                  start=state_sc, substep=30)
    for kind in ("ptbox", "ptseg"):
        drive(f"cassie {kind} pairs state path",
              CassieEnv(device=dev, observe="state", collision_pairs=_pair_sets()[kind],
                        **CASSIE_KW), 33, 5, substep_multi=5)
    from jiminy_tpu_torch.engine.ground import sample_fourier_ground
    from jiminy_tpu_torch.envs.locomotion import WalkerEnv

    s_tree, s_motors, s_stand = _sphere_model(dev)
    walker_kw = dict(stand_pose=s_stand, step_dt=0.02, sim_dt=5e-3, pgs_iters=8, observe="state",
                     device=dev)
    drive("anymal sphere feet state path", WalkerEnv(s_tree, s_motors, **walker_kw), 34, 5,
          substep_multi=5)

    def fourier(generator, batch_shape):
        return sample_fourier_ground(generator, n_terms=16, amplitude=0.08, wavelength=1.5,
                                     octaves=3, batch_shape=batch_shape)

    drive("anymal sphere feet fourier terrain path",
          WalkerEnv(s_tree, s_motors, ground_sampler=fourier, **walker_kw), 35, 5,
          substep_multi_ground=5)

    # the slice (A.14 with B.8): the flexible-hip Cassie on its state,
    # sensor and push paths, after every other Cassie part
    main_err.update(phase_flex_vs_plain(dev))
    env_f = CassieEnv(device=dev, **CASSIE_FLEX_KW)
    f_spec = env_f.engine.substep_spec
    if env_f.engine.backend != "substep" or (f_spec.tree.nv, f_spec.tree.nq, f_spec.nc) \
            != (26, 29, 28):
        raise AssertionError("the flexible Cassie env does not take the whole-substep kernel "
                             "with nv 26, nq 29, nc 28")
    state_f = drive("cassie flex state path", env_f, 40, STEPS, substep_multi=STEPS)
    _ab_cassie_substeps(env_f, state_f, act_gen, dev, CASSIE_FLEX_KW,
                        label="cassie flex state path")
    rod = _rod_error(env_f, state_f.sim)[state_f.steps >= 5]
    from jiminy_tpu_torch.math import so3

    hip = torch.cat([so3.quat_log(state_f.sim.q[:, o:o + 4]).norm(dim=1)
                     for o in f_spec.tree.sprung_spherical[1]])
    print(f"[phase 2] cassie flex state path: hip deflection |log(quat)| mean "
          f"{hip.mean().item():.4g} rad, max {hip.max().item():.4g} rad; pushrod |d − d₀| max "
          f"{rod.max().item():.3g} m over the envs 5+ steps into their episode; base height "
          f"mean {state_f.sim.q[:, 2].mean().item():.4f} m")
    if rod.max().item() > ROD_TOL:
        raise AssertionError(f"flexible Cassie: the pushrod loops open by {rod.max().item()}")
    env_fs = CassieEnv(device=dev, **CASSIE_FLEX_SENSOR_KW)
    if not env_fs._fused_sensors:
        raise AssertionError("the flexible Cassie sensor env does not take the fused sensor path")
    state_fs = drive("cassie flex sensor path", env_fs, 41, STEPS, substep_multi_sensors=STEPS)
    if state_fs.obs.shape != (B_MAIN, 29) or state_fs.info["sensor_bufs"].shape[1] != \
            env_fs.sensors.n_buf:
        raise AssertionError(f"flexible Cassie sensor obs of shape {tuple(state_fs.obs.shape)}")
    _ab_sensor_step(env_fs, state_fs, act_gen, dev, CASSIE_FLEX_SENSOR_KW,
                    label="cassie flex sensor path",
                    gate=functools.partial(_gate_dist_vs_f64, check=False))
    env_fp = CassieEnv(device=dev, **CASSIE_FLEX_PUSH_KW)
    state_fp = drive("cassie flex push path", env_fp, 42, STEPS, substep_multi=STEPS)
    print(f"[phase 2] cassie flex push path: {int((state_fp.info['push_steps_left'] > 0).sum())}"
          f"/{B_MAIN} envs being pushed")
    eng_fk3 = _cassie_engine(dev, residual=False, fusion=False, flexibility=True)
    drive_unfused("cassie flex substep_fusion=False", eng_fk3, walker=env_f, start=state_f,
                  substep=30)

    rates_c = {}
    for name, env_x, st_x in (("state", env_c, state_c), ("sensor", env_cs, state_cs),
                              ("push", env_cp, state_cp)):
        for _ in range(5):  # warm-up
            st_x = env_x.step(st_x, _uniform(act_gen, dev, 10))
        rates_c[name], _ = _env_rate(env_x, st_x, act_gen, dev, STEPS, 3)
        print(f"[phase 3] env-steps/s at B={B_MAIN}, cassie {name} path: "
              f"{[round(r, 1) for r in rates_c[name]]} (max {max(rates_c[name]):.1f})")
    for name, env_x, st_x in (("self-collision state", env_sc, state_sc),
                              ("self-collision sensor", env_scs, state_scs),
                              ("self-collision push", env_scp, state_scp)):
        for _ in range(5):  # warm-up
            st_x = env_x.step(st_x, _uniform(act_gen, dev, 10))
        torch.cuda.synchronize()
        before = _counts()
        rates_c[name], _ = _env_rate(env_x, st_x, act_gen, dev, STEPS, 3)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        print(f"[phase 3] env-steps/s at B={B_MAIN}, cassie {name} path: "
              f"{[round(r, 1) for r in rates_c[name]]} (max {max(rates_c[name]):.1f}); launches in "
              f"the {3 * STEPS} timed steps {json.dumps(launched)}")
    for name, env_x, st_x, launch in (("flex state", env_f, state_f, "substep_multi"),
                                      ("flex sensor", env_fs, state_fs, "substep_multi_sensors"),
                                      ("flex push", env_fp, state_fp, "substep_multi")):
        for _ in range(5):  # warm-up
            st_x = env_x.step(st_x, _uniform(act_gen, dev, 10))
        torch.cuda.synchronize()
        before = _counts()
        rates_c[name], _ = _env_rate(env_x, st_x, act_gen, dev, STEPS, 3)
        launched = {n: c - before[n] for n, c in _counts().items() if c != before[n]}
        print(f"[phase 3] env-steps/s at B={B_MAIN}, cassie {name} path: "
              f"{[round(r, 1) for r in rates_c[name]]} (max {max(rates_c[name]):.1f}); launches in "
              f"the {3 * STEPS} timed steps {json.dumps(launched)}")
        if launched != {launch: 3 * STEPS}:
            raise AssertionError(f"cassie {name} path: {launched} in {3 * STEPS} env steps")

    # Cassie (B.9 and the springs, the large frame): K2 over the env step's
    # 10 substeps, with the sensor stage (10 updates), and K3
    ceng = _cassie_engine(dev, residual=False, fusion=False)
    cspec = ceng.substep_spec
    cq, cv, ccmd, clam0, cwrench = cargs = _cassie_inputs(
        ceng, torch.Generator(device=dev).manual_seed(25), B_MAIN)
    ctau = ceng._joint_torque(ccmd, cq, cv)
    c_sub = env_c.n_substeps
    csens = SensorKernelSpec(ceng.tree, env_cs.sensors, env_cs.n_substeps_per_obs)
    c_upd = c_sub // csens.k_obs
    csuite = env_cs.sensors
    cgen = torch.Generator(device=dev).manual_seed(26)
    csw = dict(sensors=csens, bufs=csuite.flatten_buffers(csuite.reset(
        csuite.sample_eps(cgen, B_MAIN), cq, cv)),
        eps=torch.cat([csuite.sample_eps(cgen, B_MAIN) for _ in range(c_upd)], 1))
    c_ops = B_MAIN * (c_sub * (_substep_flops(cspec) + _torque_flops(cspec)) + 2 * cspec.tree.nv)
    print(f"[phase 3] cassie: {_substep_flops(cspec)} FLOP per env per substep (distance rows "
          f"{_distance_flops(cspec)}, springs {_spring_flops(cspec)}, chain "
          f"{_solve_flops(cspec.cfg)}), torque {_torque_flops(cspec)}; ANYmal's substep "
          f"{_substep_flops(spec)}")
    b9 = "jiminy_tpu/ops/substep_kernel.py:933"
    entry(
        "cassie_substep_multi", WARP_SOURCE, b9,
        path["cassie state path"]["substep_multi"],
        _time_cuda(lambda: substep_batched_multi(cspec, c_sub, *cargs), 10),
        _time_cuda(lambda: substep_multi_reference(cspec, c_sub, *cargs), 2),
        _substep_multi_bytes(cspec, B_MAIN), c_ops,
    )
    entry(
        "cassie_substep_multi_sensors", WARP_SOURCE, b9,
        path["cassie sensor path"]["substep_multi_sensors"],
        _time_cuda(lambda: substep_batched_multi(cspec, c_sub, *cargs, **csw), 10),
        _time_cuda(lambda: substep_multi_reference(cspec, c_sub, *cargs, **csw), 2),
        _substep_multi_bytes(cspec, B_MAIN) + _sensor_bytes(csens, B_MAIN, c_upd),
        c_ops + B_MAIN * c_upd * _sensor_flops(cspec, csens),
    )
    entry(
        "cassie_substep", WARP_SOURCE, b9,
        path["cassie substep_fusion=False"]["substep"],
        _time_cuda(lambda: substep_batched(cspec, cq, cv, ctau, clam0, cwrench), 20),
        _time_cuda(lambda: substep_reference(cspec, cq, cv, ctau, clam0, cwrench), 3),
        _substep_bytes(cspec, B_MAIN), B_MAIN * _substep_flops(cspec),
    )

    # B.7 (the pair narrow phases) on Cassie: the slice's seg pairs (K2 over
    # the env step's 10 substeps, and K3), the ptbox and ptseg pair sets (K2)
    pgen = torch.Generator(device=dev).manual_seed(27)
    b7 = "jiminy_tpu/ops/substep_kernel.py:998"
    for kind, pairs in _pair_sets().items():
        peng = _cassie_engine(dev, residual=False, fusion=False, pairs=pairs)
        pspec = peng.substep_spec
        pargs = _selfcol_inputs(peng, pgen, B_MAIN)
        p_ops = B_MAIN * (c_sub * (_substep_flops(pspec) + _torque_flops(pspec))
                          + 2 * pspec.tree.nv)
        print(f"[phase 3] pairs {kind}: {_substep_flops(pspec)} FLOP per env per substep (pairs "
              f"{_pair_flops(pspec)}, chain {_solve_flops(pspec.cfg)} at nc {pspec.nc})")
        name = "cassie_selfcol_substep_multi" if kind == "seg" else f"pairs_{kind}_substep_multi"
        launched_by = ("cassie self-collision state path" if kind == "seg"
                       else f"cassie {kind} pairs state path")
        main_err[name] = main_err[f"pairs_{kind}"]
        entry(
            name, WARP_SOURCE, b7, path[launched_by]["substep_multi"],
            _time_cuda(lambda: substep_batched_multi(pspec, c_sub, *pargs), 10),
            _time_cuda(lambda: substep_multi_reference(pspec, c_sub, *pargs), 2),
            _substep_multi_bytes(pspec, B_MAIN), p_ops,
        )
        if kind == "seg":
            pq, pv, pcmd, plam0, pwrench = pargs
            ptau = peng._joint_torque(pcmd, pq, pv)
            main_err["cassie_selfcol_substep"] = main_err["pairs_seg"]
            entry(
                "cassie_selfcol_substep", WARP_SOURCE, b7,
                path["cassie self-collision substep_fusion=False"]["substep"],
                _time_cuda(lambda: substep_batched(pspec, pq, pv, ptau, plam0, pwrench), 20),
                _time_cuda(lambda: substep_reference(pspec, pq, pv, ptau, plam0, pwrench), 3),
                _substep_bytes(pspec, B_MAIN), B_MAIN * _substep_flops(pspec),
            )
    # B.4′ (the sphere sites' offset) on ANYmal's feet: K2 over the env
    # step's 4 substeps on flat ground and on a Fourier ground per env
    sgen = torch.Generator(device=dev).manual_seed(28)
    b4s = "jiminy_tpu/ops/substep_kernel.py:862"
    for kind in ("flat", "fourier"):
        template = _ground_template(kind, dev) if kind != "flat" else None
        seng = _sphere_engine(dev, ground=template, fusion=False)
        sspec = seng.substep_spec
        if kind == "flat":
            sargs, sgc, g_bytes, g_ops = _substep_inputs(seng, sgen, B_MAIN), None, 0, 0
            name, counter, launched_by = ("sphere_sites_substep_multi", "substep_multi",
                                          "anymal sphere feet state path")
        else:
            sargs, sgc, _ = _ground_inputs(seng, kind, sgen, B_MAIN)
            g_bytes, g_ops = 4 * sgc.numel(), B_MAIN * n_sub * _ground_flops(sspec)
            name, counter, launched_by = ("sphere_sites_substep_multi_ground",
                                          "substep_multi_ground",
                                          "anymal sphere feet fourier terrain path")
        main_err[name] = main_err[f"spheres_{kind}"]
        s_ops = B_MAIN * (n_sub * (_substep_flops(sspec) + _torque_flops(sspec))
                          + 2 * sspec.tree.nv)
        entry(
            name, WARP_SOURCE, b4s, path[launched_by][counter],
            _time_cuda(lambda: substep_batched_multi(sspec, n_sub, *sargs, gc=sgc), 20),
            _time_cuda(lambda: substep_multi_reference(sspec, n_sub, *sargs, gc=sgc), 3),
            _substep_multi_bytes(sspec, B_MAIN) + g_bytes, s_ops + g_ops,
        )
    # B.8 (spherical flexibility) on the slice: K2 over the env step's 10
    # substeps, with the sensor stage (10 updates, three IMUs), and K3
    feng = _cassie_engine(dev, residual=False, fusion=False, flexibility=True)
    fspec = feng.substep_spec
    fargs = _flex_inputs(feng, torch.Generator(device=dev).manual_seed(29), B_MAIN)[0]
    fq, fv, fcmd, flam0, fwrench = fargs
    ftau = feng._joint_torque(fcmd, fq, fv)
    fsens = SensorKernelSpec(feng.tree, env_fs.sensors, env_fs.n_substeps_per_obs)
    fsuite, fgen = env_fs.sensors, torch.Generator(device=dev).manual_seed(30)
    fsw = dict(sensors=fsens, bufs=fsuite.flatten_buffers(fsuite.reset(
        fsuite.sample_eps(fgen, B_MAIN), fq, fv)),
        eps=torch.cat([fsuite.sample_eps(fgen, B_MAIN) for _ in range(c_upd)], 1))
    f_ops = B_MAIN * (c_sub * (_substep_flops(fspec) + _torque_flops(fspec)) + 2 * fspec.tree.nv)
    print(f"[phase 3] cassie flex: {_substep_flops(fspec)} FLOP per env per substep (chain "
          f"{_solve_flops(fspec.cfg)} at nv {fspec.tree.nv}), torque {_torque_flops(fspec)}, "
          f"sensor update {_sensor_flops(fspec, fsens)}; the rigid Cassie's substep "
          f"{_substep_flops(cspec)}")
    b8 = "jiminy_tpu/ops/substep_kernel.py:448"
    entry(
        "cassie_flex_substep_multi", WARP_SOURCE, b8,
        path["cassie flex state path"]["substep_multi"],
        _time_cuda(lambda: substep_batched_multi(fspec, c_sub, *fargs), 10),
        _time_cuda(lambda: substep_multi_reference(fspec, c_sub, *fargs), 2),
        _substep_multi_bytes(fspec, B_MAIN), f_ops,
    )
    entry(
        "cassie_flex_substep_multi_sensors", WARP_SOURCE, b8,
        path["cassie flex sensor path"]["substep_multi_sensors"],
        _time_cuda(lambda: substep_batched_multi(fspec, c_sub, *fargs, **fsw), 10),
        _time_cuda(lambda: substep_multi_reference(fspec, c_sub, *fargs, **fsw), 2),
        _substep_multi_bytes(fspec, B_MAIN) + _sensor_bytes(fsens, B_MAIN, c_upd),
        f_ops + B_MAIN * c_upd * _sensor_flops(fspec, fsens),
    )
    entry(
        "cassie_flex_substep", WARP_SOURCE, b8,
        path["cassie flex substep_fusion=False"]["substep"],
        _time_cuda(lambda: substep_batched(fspec, fq, fv, ftau, flam0, fwrench), 20),
        _time_cuda(lambda: substep_reference(fspec, fq, fv, ftau, flam0, fwrench), 3),
        _substep_bytes(fspec, B_MAIN), B_MAIN * _substep_flops(fspec),
    )
    _lap("phases 1-3: Cassie, its pairs, the sphere feet and the flexible hips")
    # ---- B.10 on the reference's PRISMATIC kernel scene and its oblique
    # twin (the large frame: nc 48), after every other part
    main_err.update(phase_prismatic_vs_plain(dev, ("slab", "oblique")))
    path["prismatic slab engine path"], sim_sl, eng_sl = _prismatic_path(dev, "slab", STEPS)
    cube_z = sim_sl.q[:, 3]
    print(f"[phase 2] prismatic slab engine path, {STEPS} steps of {SLAB_SUBSTEPS} substeps at "
          f"B={B_MAIN}: launches "
          f"{json.dumps({n: c for n, c in path['prismatic slab engine path'].items() if c})}; "
          f"cube height {cube_z.min().item():.5f}–{cube_z.max().item():.5f} m over the slab's face "
          f"at 0.1 m (resting: 0.2); slab q {sim_sl.q[:, 0].min().item():.3g}–"
          f"{sim_sl.q[:, 0].max().item():.3g} m; share of envs with an active pair row "
          f"{_active_pair_share(eng_sl, sim_sl.q):.4f}")
    if path["prismatic slab engine path"] != _only(substep_multi=STEPS) \
            or cube_z.min().item() < 0.19:
        raise AssertionError(f"prismatic slab engine path: launches "
                             f"{path['prismatic slab engine path']}, lowest cube {cube_z.min()}")
    path["prismatic slab substep_fusion=False"] = _prismatic_path(dev, "slab", 3, fusion=False)[0]
    if path["prismatic slab substep_fusion=False"] != _only(substep=3 * SLAB_SUBSTEPS):
        raise AssertionError(f"slab unfused: {path['prismatic slab substep_fusion=False']}")
    sl_cmd = torch.zeros(B_MAIN, 1, device=dev)
    rates_sl = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            sim_sl = eng_sl.step(sim_sl, sl_cmd, n_substeps=SLAB_SUBSTEPS)
        torch.cuda.synchronize()
        rates_sl.append(B_MAIN * STEPS / (time.perf_counter() - t0))
    print(f"[phase 3] steps/s at B={B_MAIN}, prismatic slab engine path ({SLAB_SUBSTEPS} "
          f"substeps of 1 ms): {[round(r, 1) for r in rates_sl]} (max {max(rates_sl):.1f})")
    sl_spec = eng_sl.substep_spec
    sl_args = _slab_inputs(eng_sl, torch.Generator(device=dev).manual_seed(82), B_MAIN)
    sq, sv, scmd, slam0, swrench = sl_args
    sl_tau = eng_sl._joint_torque(scmd, sq, sv)
    print(f"[phase 3] prismatic slab: {_substep_flops(sl_spec)} FLOP per env per substep (pairs "
          f"{_pair_flops(sl_spec)}, chain {_solve_flops(sl_spec.cfg)} at nc {sl_spec.nc}); "
          f"the cartpole's {_substep_flops(cp_spec)}")
    entry(
        "prismatic_slab_substep_multi", WARP_SOURCE, b10,
        path["prismatic slab engine path"]["substep_multi"],
        _time_cuda(lambda: substep_batched_multi(sl_spec, SLAB_SUBSTEPS, *sl_args), 20),
        _time_cuda(lambda: substep_multi_reference(sl_spec, SLAB_SUBSTEPS, *sl_args), 2),
        _substep_multi_bytes(sl_spec, B_MAIN),
        B_MAIN * (SLAB_SUBSTEPS * (_substep_flops(sl_spec) + _torque_flops(sl_spec))
                  + 2 * sl_spec.tree.nv),
    )
    entry(
        "prismatic_slab_substep", WARP_SOURCE, b10,
        path["prismatic slab substep_fusion=False"]["substep"],
        _time_cuda(lambda: substep_batched(sl_spec, sq, sv, sl_tau, slam0, swrench), 20),
        _time_cuda(lambda: substep_reference(sl_spec, sq, sv, sl_tau, slam0, swrench), 3),
        _substep_bytes(sl_spec, B_MAIN), B_MAIN * _substep_flops(sl_spec),
    )
    _lap("phases 1-3: the slab scene")
    # ---- A.23: the Atlas humanoid, its pairs the largest frame (nc 83), after
    # every other part
    main_err.update(phase_atlas_vs_plain(dev))
    rates_a = phase_atlas_paths(dev, drive, drive_unfused, entry, path, act_gen)
    _lap("phases 1-3: Atlas")
    # ---- A.22, A.24: the kinematic constraints, per-body wrenches and
    # per-env friction on the chain kernel, after every other part
    rates_chain = phase_chain_paths(dev, drive, entry, main_err, path, act_gen)
    _lap("the chain-kernel paths")
    # ---- A.16: the paths off the impulse engine, after every other part
    penalty = phase_penalty_paths(dev, drive, entry, main_err, path, act_gen)

    # after every large-frame launch: the ANYmal sensor K2 again, beside its
    # time before them (every kernel runs the warp body; none keeps local
    # memory that a launch could grow)
    late_ms = _time_cuda(sensor_k2, 20)
    print(f"[phase 3] substep_multi_sensors B={B_MAIN} after the large-frame launches: "
          f"{late_ms:.4f} ms against {sensor_k2_ms:.4f} ms before them "
          f"({late_ms / sensor_k2_ms:.4f}×)")
    _lap("the paths off the impulse engine and the late K2 timing")
    # ---- phase 4: the policy and PPO, after every kernel number
    training = phase_training(dev)
    _lap("phase 4: the policy and PPO")
    # ---- phase 5: the declarative layer (A.17), after every other path
    declarative = phase_declarative(dev)
    _lap("phase 5: the declarative layer")
    # ---- phase 6: the URDF builders (A.20) and scale-out (A.18)
    urdf_scaleout = phase_urdf_and_scaleout(dev, drive, entry, main_err, path)
    _lap("phase 6: the URDF builders and scale-out")
    # ---- phase 7: the convenience layer (A.19, A.25), last
    convenience = phase_convenience(dev, path, kernels)
    _lap("phase 7: the convenience layer")
    print(f"[seconds] the whole run: {time.perf_counter() - _CLOCK['start']:.1f} s on this host, "
          f"whose K2 state path ran {max(rates):.1f} env-steps/s (phase 3)")
    print(json.dumps({"env_steps_per_s": rates, "env_steps_per_s_sensor_path": rates_s,
                      "env_steps_per_s_terrain_path": rates_t,
                      "env_steps_per_s_sim2real_path": rates_r,
                      "env_steps_per_s_kernel_path": rates_k1,
                      "env_steps_per_s_unfused_path": rates_k3,
                      "env_steps_per_s_cassie": rates_c, "env_steps_per_s_walkers": rates_w,
                      "steps_per_s_prismatic_slab": rates_sl, "env_steps_per_s_atlas": rates_a,
                      "env_steps_per_s_chain_paths": rates_chain,
                      "penalty_paths": penalty,
                      "nvcc_build_s": build,
                      "ppo": training, "declarative": declarative,
                      "urdf_and_scaleout": urdf_scaleout, "convenience": convenience}))
    print(json.dumps({"kernels": kernels}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
