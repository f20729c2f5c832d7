"""Frozen copy of plslam_tpu_torch/constants.py: the benchmark's reference imports nothing of the port.

Every hard-coded threshold of the reference, in one place.

The reference (maxee1900/RGBD-PL-SLAM, an ORB-SLAM2 fork) scatters these
constants through its source; each entry below names its reference site
(SURVEY.md §6 "Config/flag system" row mandates this file). Values follow the
canonical ORB-SLAM2 layout since the reference preserves it verbatim
(SURVEY.md §0).

Capacities (MAX_*) are ours: the TPU-native answer to the reference's
unbounded heap-allocated map is fixed-capacity ring-buffered arrays with
validity masks (SURVEY.md §6 "Long-context" row).
"""

# --- chi-square gates (src/Optimizer.cc ~250: PoseOptimization Huber deltas) ---
CHI2_MONO = 5.991  # 2-dof 95%  (EdgeSE3ProjectXYZOnlyPose)
CHI2_STEREO = 7.815  # 3-dof 95%  (EdgeStereoSE3ProjectXYZOnlyPose)
CHI2_LINE = 5.991  # 2-dof line endpoint residual (EdgeLineProjectXYZOnlyPose)
CHI2_SIM3 = 9.210  # OptimizeSim3 inlier gate (src/Optimizer.cc ~1100)

# --- matcher thresholds (src/ORBmatcher.cc header consts) ---
TH_LOW = 50  # Hamming accept for projection search
TH_HIGH = 100  # Hamming accept for BoW / relocalization search
HISTO_LENGTH = 30  # rotation-consistency histogram bins
NN_RATIO_DEFAULT = 0.6  # best/second-best ratio (call-site dependent 0.6-0.9)

# --- ORB extractor (Examples/RGB-D/TUM*.yaml + src/ORBextractor.cc) ---
N_FEATURES = 1000
SCALE_FACTOR = 1.2
N_LEVELS = 8
INI_TH_FAST = 20
MIN_TH_FAST = 7
FAST_CELL = 32  # reference uses 30x30 cells (ComputeKeyPointsOctTree ~750);
# 32 chosen for TPU tile alignment — behaviorally equivalent spatial spread.
PATCH_SIZE = 31  # IC-angle / BRIEF patch diameter (src/ORBextractor.cc)
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19  # border margin before FAST (src/ORBextractor.cc)

# --- line extractor (LSD/LBD, src/LineExtractor.cc + OpenCV defaults) ---
LBD_BANDS = 9  # BinaryDescriptor numOfBands
LBD_BAND_WIDTH = 7  # BinaryDescriptor widthOfBand
MIN_LINE_LENGTH_FRAC = 0.025  # min line length as fraction of image diagonal

# --- covisibility graph (src/KeyFrame.cc §UpdateConnections ~330) ---
COVIS_TH = 15  # min shared landmarks for a covisibility edge
COVIS_ESSENTIAL_TH = 100  # strong edges kept in the essential graph

# --- tracking policy (src/Tracking.cc) ---
TH_DEPTH_DEFAULT = 40.0  # ThDepth: close/far split = ThDepth * baseline
MIN_INLIERS_TRACK_LOCAL_MAP = 30  # TrackLocalMap accept (~900)
# chi2-validated line inliers count toward the TrackLocalMap gate with this
# weight (each line edge = TWO endpoint-to-line residuals; the PL fork's
# line-dominant low-texture tracking depends on lines carrying the gate)
LINE_INLIER_GATE_WEIGHT = 2
MIN_INLIERS_AFTER_RELOC = 50
MIN_MATCHES_MOTION_MODEL = 20  # TrackWithMotionModel (~700)
MIN_MATCHES_REF_KF = 15  # TrackReferenceKeyFrame (~600)
KF_TRACKED_CLOSE_MIN = 100  # NeedNewKeyFrame (~1000)
KF_NONTRACKED_CLOSE_MIN = 70
KF_REF_RATIO_RGBD = 0.75  # tracked / ref-KF-tracked ratio threshold
KF_MAX_FRAMES = 30  # MaxFrames = fps: force KF after this many frames
KF_MIN_FRAMES = 0
NEW_KF_MAX_CLOSE_POINTS = 100  # CreateNewKeyFrame (~1100) depth-sorted cap

# --- local mapping (src/LocalMapping.cc) ---
CULL_FOUND_RATIO = 0.25  # MapPointCulling (~180)
CULL_UNSEEN_KFS = 3
KF_CULL_REDUNDANCY = 0.9  # KeyFrameCulling (~650): >=90% landmarks seen >=3x
KF_CULL_MIN_OBS = 3
TRIANG_COVIS_KFS = 10  # CreateNewMapPoints neighbor count (~250)

# --- loop closing (src/LoopClosing.cc) ---
LOOP_MIN_KFS_SINCE_LAST = 10  # DetectLoop (~80)
LOOP_CONSISTENT_GROUPS = 3
LOOP_BOW_MIN_MATCHES = 20  # ComputeSim3 (~200)
LOOP_MIN_SCORE_FALLBACK = 0.05  # detect() min-score when the query KF has no
# covisible neighbours (the reference always has neighbours; this is the
# bootstrap edge case). Measured on the perceptual-aliasing fixture
# (tests/test_vocab.py, trained vocab): true-revisit median score 0.35,
# cross-scene p95 0.12 — 0.05 never rejects a real revisit, and alias
# rejection is carried by the shared-word gate + group accumulation +
# 3-consecutive-KF consistency, not by this floor.
LOOP_SIM3_MIN_INLIERS = 20
LOOP_TOTAL_MIN_MATCHES = 40
LOOP_TEMPORAL_GATE_FRAMES = 30  # candidates must be > ~1 s (one KF_MAX_FRAMES
# window) older than the query — DetectLoop excludes covisible/adjacent KFs
# (src/LoopClosing.cc ~80 skips mLastLoopKFid-adjacent + covisible neighbours)
LOOP_MAX_CANDIDATES = 5  # enough-consistent candidates tried per detection,
# best BoW score first (mvpEnoughConsistentCandidates is unbounded in the
# reference but ComputeSim3 in practice sees <5; bounded here for the
# host-side loop)
LOOP_MAX_GROUPS = 16  # consistency groups carried across keyframes in the
# device-resident detector (mvConsistentGroups is unbounded in the reference;
# survivors of the accumulated-score gate are <5 in practice — 16 is
# headroom, top-scoring groups kept if ever exceeded)

# --- optimizer iteration schedules (src/Optimizer.cc) ---
POSE_OPT_ROUNDS = 4  # PoseOptimization: 4 rounds x 10 LM iters (~250)
POSE_OPT_SCHEDULE = (4, 2, 2, 2)  # our compressed per-round LM iteration
# counts (reference: 10 each). Measured on the bench fixture: rounds past
# these converge below the chi2 re-classification noise floor, and each
# unrolled iteration is traced into the step program (solvers/pose.py).
LOCAL_BA_ITERS_1 = 5  # LocalBundleAdjustment: 5 then 10 (~450)
LOCAL_BA_ITERS_2 = 10
GLOBAL_BA_ITERS = 10  # RunGlobalBundleAdjustment (~600)
GBA_SLICE_ITERS = 5  # LM iterations per time-sliced GBA dispatch: the
# transient-GBA-thread analogue (LoopClosing::RunGlobalBundleAdjustment runs
# while tracking continues) — System pumps one slice between frames, so a
# closure's GBA cost spreads over ceil(10/5)*2 = 4 frames instead of one
# frame-time spike
ESSENTIAL_GRAPH_ITERS = 20  # OptimizeEssentialGraph (~900)
SIM3_OPT_ITERS = 10  # OptimizeSim3 (~1100)

# --- observation octave noise model (g2o edge info matrices) ---
# invSigma2 = 1 / SCALE_FACTOR**(2*octave)

# --- fixed capacities (ours; TPU-native bounded map, SURVEY.md §6) ---
MAX_FEAT = 1024  # per-frame keypoint capacity (nFeatures=1000 padded)
MAX_LINES = 128  # per-frame keyline capacity
MAX_KF = 256  # keyframe capacity
MAX_PTS = 32768  # map-point capacity
MAX_MAPLINES = 4096  # map-line capacity
LOCAL_KFS = 16  # local-BA window keyframe capacity (reference: ALL covisible
# KFs, unbounded; 16 covers the covisible set on every fixture we track)
LOCAL_FIXED_KFS = 16  # local-BA fixed boundary keyframe capacity
LOCAL_SET_CAP = 4096  # TrackLocalMap working-set capacity: landmark ids of
# the reference KF + its top covisible KFs (Tracking::UpdateLocalPoints
# ~850). Stage-2 matching/visibility in the step run over this gathered set,
# not all MAX_PTS slots — the reference's local map as a fixed-capacity id
# list refreshed at KF insertion (an 8x cut of the per-frame
# [MAX_FEAT, MAX_PTS] distance work).
LOCAL_COVIS_KFS = 16  # covisible KFs contributing to the working set
# (Tracking::UpdateLocalKeyFrames caps the local-KF list; top-N by weight)

# --- vocabulary (Thirdparty/DBoW2; Vocabulary/ORBvoc.txt: k=10, L=6) ---
VOCAB_K = 10
VOCAB_L = 4  # ours is trained small (no ORBvoc asset offline; SURVEY.md §10.6)
