"""Configuration system of the PyTorch port.

A copy of ``mpc_sensorlessao_tpu/utils/config.py``: the dataclasses are
pure Python, but importing them from the JAX package would pull in jax.
Both packages must build the same scenario from the same config, so the
two files hold the same dataclasses, fields and defaults.

The reference implementation hard-codes every scenario constant as MATLAB
script variables (reference: README.md:36-49,337-362) and has no config
system at all (SURVEY.md section 5.6).  Here every subsystem gets a frozen,
hashable dataclass so configs can be swept over scenario grids.

Defaults reproduce the reference benchmark scenario:
D=1 m, r0=0.2 m (D/r0=5), L0=42 m, 3 frozen-flow layers, 28 Zernike modes
(radial order 6), VAR(2), horizon N=2, Q=1.5e4*I, R=I, u_max=28 rad,
du_max=0.2121 rad, SNR 10 dB, barrier k=0.01, 1 Newton step
(reference: README.md:36-49,337-362,538-553).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TelescopeConfig:
    """Telescope geometry (reference: README.md:54-60, telescope.m:83)."""

    diameter: float = 1.0              # [m]
    resolution: int = 128              # pupil-plane grid size (nRes)
    fov_arcsec: float = 2.5            # field of view [arcsec]
    sampling_freq: float = 200.0       # turbulence sampling frequency [Hz]

    @property
    def sampling_time(self) -> float:
        return 1.0 / self.sampling_freq

    @property
    def pixel_pitch(self) -> float:
        # OOMAO convention: nPixel points span D -> pitch D/(nPixel-1)
        # (reference: atmosphere.m:449, L=(N-1)*D/(nPixel-1)).
        return self.diameter / (self.resolution - 1)


@dataclass(frozen=True)
class AtmosphereConfig:
    """Multi-layer Von Karman atmosphere (reference: README.md:40-51,
    atmosphere.m:119-162)."""

    r0: float = 0.2                    # Fried parameter [m]
    L0: float = 42.0                   # outer scale [m]
    wavelength: float = 550e-9         # r0 defined at V band (photometry.m:50)
    altitudes: Tuple[float, ...] = (1000.0, 5000.0, 12000.0)          # [m]
    wind_speeds: Tuple[float, ...] = (5.0, 7.5, 10.0)                 # [m/s]
    wind_directions: Tuple[float, ...] = (0.0, math.pi / 3, 5 * math.pi / 3)
    fractional_r0: Tuple[float, ...] = (0.7 / 25, 0.1 / 25, 0.2 / 25)
    oversample: int = 4                # FFT screen oversampling (atmosphere.m:447)
    subharmonic_levels: int = 3        # low-frequency compensation depth
    # Frozen-flow evolution scheme:
    # "periodic":    sampled periodic oversampled screens (the fast path,
    #                ops/phase_screens.py);
    # "conditional": conditional-Gaussian border extension, the
    #                reference-parity stochastic flow
    #                (telescopeAbstract.m:823-901; ops/edge_flow.py).
    flow: str = "periodic"
    # Storage dtype for the conditional-flow conditioning operators A/Bc
    # (ops/edge_flow.py).  "bfloat16" halves the HBM traffic of the
    # R=512 border draws; the MXU already truncates f32 matmul operands
    # to bf16 at default precision, so the computed draws are
    # (near-)identical (accumulation stays f32).  State screens are
    # always float32.
    edge_op_dtype: str = "float32"

    @property
    def n_layers(self) -> int:
        return len(self.altitudes)

    # -- derived observables (reference: atmosphere.m:296-374) --
    # implemented in ops.phase_stats (local imports: phase_stats imports
    # this module)

    @property
    def seeing_arcsec(self) -> float:
        """0.98 lambda/r0 [arcsec] (atmosphere.m:297-300)."""
        from ..ops import phase_stats
        return phase_stats.seeing_arcsec(self)

    @property
    def theta0_arcsec(self) -> float:
        """Isoplanatic angle, Roddier decay (atmosphere.m:319-334)."""
        from ..ops import phase_stats
        return phase_stats.theta0_arcsec(self)

    @property
    def tau0_ms(self) -> float:
        """Coherence time, Roddier decay (atmosphere.m:337-353)."""
        from ..ops import phase_stats
        return phase_stats.tau0_ms(self)

    @property
    def greenwood_frequency(self) -> float:
        """0.4292 meanWind/r0 [Hz] (atmosphere.m:368-374)."""
        from ..ops import phase_stats
        return phase_stats.greenwood_frequency(self)

    def layer(self, i: int) -> "AtmosphereConfig":
        """Single-layer slab view (reference: atmosphere.m:169 `slab`)."""
        return dataclasses.replace(
            self,
            altitudes=(self.altitudes[i],),
            wind_speeds=(self.wind_speeds[i],),
            wind_directions=(self.wind_directions[i],),
            fractional_r0=(self.fractional_r0[i],),
        )


def mag_conv(d_over_r0: float, base: float = 5.0) -> float:
    """Turbulence-strength scaling multiplier.

    The reference ships precomputed multipliers mag_conv_{5,10,15,20}
    (reference: README.md:277-281); they follow the Kolmogorov phase-rms
    scaling (D/r0)^(5/6):  (10/5)^(5/6)=1.7818, (15/5)^(5/6)=2.4980,
    (20/5)^(5/6)=3.1748.
    """
    return float((d_over_r0 / base) ** (5.0 / 6.0))


@dataclass(frozen=True)
class ZernikeConfig:
    """Zernike modal basis (reference: README.md:38,86; zernmodfit.m:195-198)."""

    radial_order: int = 6              # N=6 -> 28 modes

    @property
    def n_modes(self) -> int:
        n = self.radial_order
        return (n + 1) * (n + 2) // 2

    @property
    def n_states(self) -> int:
        """Modes excluding piston (piston removed: README.md:110,290,331)."""
        return self.n_modes - 1


@dataclass(frozen=True)
class DMConfig:
    """Deformable mirror with Gaussian influence functions
    (reference: README.md:193-234)."""

    n_act_side: int = 12               # m1 -> 144 actuators
    coupling: float = 0.1              # influence coupling at one pitch
    # Influence-function family: "gaussian" (the reference pipeline's
    # inline model, README.md:230), or the OOMAO influenceFunction Bezier
    # profiles "bezier_monotonic" / "bezier_overshoot"
    # (influenceFunction.m:57-62).
    influence: str = "gaussian"
    diameter: float = 4.4e-3           # DM aperture [m]
    half_width: float = 2.2e-3         # DM grid half extent [m] (README.md:206)
    pixel_pitch: float = 6.5e-6        # [m] (README.md:194)
    # Voltage conversion  V = (-b +/- sqrt(b^2 +/- 4 a u nm))/(2a)
    # (reference: README.md:350,576-583)
    coeff_a: float = 0.047275
    coeff_b: float = 2.709264

    @property
    def n_actuators(self) -> int:
        return self.n_act_side ** 2

    @property
    def pitch(self) -> float:
        return self.diameter / (self.n_act_side - 1)


@dataclass(frozen=True)
class EstimatorConfig:
    """Phase-diversity PSF estimator (reference: README.md:366-397,457-480)."""

    resolution: int = 128              # pupil/FFT grid (len; reference uses 512)
    diversity_mode: int = 4            # 0-based defocus index (MATLAB idx2=5)
    diversity_amp: float = 3.0         # zd in {-amp, 0, amp} (README.md:395-396)
    crop_half: int = 15                # 31x31 crop (README.md:378-380)
    au: float = 1e12                   # arbitrary PSF unit (README.md:381)
    camera_wavelength: float = 532e-9  # [m] (README.md:372)
    pixel_pitch: float = 6.5e-6        # [m] (README.md:371)
    snr_db: float = 10.0               # measurement SNR (README.md:295)
    # SNR signal reference for the regenerated noise (the reference's
    # SNR_10.mat blob is missing, SURVEY.md 2c, so the definition is ours):
    # "mean_abs":     sigma = mean(|b_s|) * 10^(-SNR/20)   (default; average
    #                 per-pixel signal level -- yields the operating point
    #                 the published closed loop implies)
    # "vector_power": sigma^2 = mean(b_s^2) * 10^(-SNR/10) (MATLAB
    #                 awgn-style; peak-dominated, ~15x stronger)
    snr_reference: str = "mean_abs"
    tikhonov: float = 0.0              # optional LS regularization
    # DFT matmul operand precision for the measurement path: "float32"
    # (default, bit-stable) or "bfloat16" (MXU-native mixed precision,
    # ~2x matmul throughput; ~0.4% spectrum error, far below the 10 dB
    # noise floor -- see dft.partial_centered_fft2_real).
    dft_dtype: str = "float32"
    # Estimation method:
    # "ls":   plain normal-equation least squares (the reference,
    #         README.md:478);
    # "mmse": Bayesian linear MMSE  x = C A'(A C A' + sigma^2 I)^-1 (y-b)
    #         with C the *analytic* Von Karman Zernike-coefficient
    #         covariance (ops/zernike_stats.py) scaled by prior_scale^2.
    #         Shrinks weakly-sensed (high-order) modes toward zero instead
    #         of amplifying measurement noise -- the equivalent capability
    #         of the reference's bundled linearMMSE reconstructor
    #         (OOMAO-master/linearMMSE.m), applied to phase diversity.
    method: str = "ls"
    # Prior std scale for "mmse": 1.0 = open-loop turbulence statistics
    # (conservative in closed loop, where the residual is far smaller;
    # smaller values shrink harder).
    prior_scale: float = 1.0
    # Fixed-Jacobian Gauss-Newton refinement iterations: 0 reproduces the
    # reference's single linearization (README.md:478); >=1 iterates
    # x <- x + S(y - f(x)) with the exact PSF model, widening the capture
    # range for strong-turbulence windows (see estimator.py).
    gauss_newton_iters: int = 1
    # Tracking-estimator iterations: >=1 arms an in-loop recovery path --
    # full re-linearized Gauss-Newton (estimator.estimate_full_gn) seeded
    # by continuity (previous estimate + B du), taking over only when the
    # base estimate stops explaining the measured PSFs (chi-square rule in
    # closed_loop).  MEASURED NEGATIVE RESULT (R=128, D/r0=15-20, 500
    # steps): the seeded-GN takeover converges to data-consistent but
    # wrong speckle branches and keeps the loop out, whereas the shrunk
    # MMSE estimator (prior_scale ~ 0.5/(D/r0)) self-recovers -- prefer
    # prior shrinkage for strong turbulence; estimate_full_gn remains
    # valuable for offline/acquisition (tracks |x| ~ 9 rad when seeded
    # within ~0.5 rad).  Cost: ~n_states extra partial-DFT builds per
    # iteration per step.
    track_gn_iters: int = 0

    @property
    def n_diversities(self) -> int:
        return 3

    @property
    def crop_size(self) -> int:
        return 2 * self.crop_half + 1

    @property
    def n_pixels(self) -> int:
        """Stacked measurement length p (2883 for the reference)."""
        return self.n_diversities * self.crop_size ** 2

    @property
    def rad_to_nm(self) -> float:
        return self.camera_wavelength / (2 * math.pi) * 1e9


@dataclass(frozen=True)
class MPCConfig:
    """MPC cost, constraints and solver (reference: README.md:337-356,536-556)."""

    horizon: int = 2                   # N
    var_order: int = 2                 # VAR(p), p in {1, 2}
    # Identification regularization (0 = the reference's plain LS,
    # README.md:127): scale-invariant ridge on the lagged normal
    # equations; essential for high-order mode sets (see var.fit).
    var_ridge: float = 0.0
    # Hard stability cap on the identified model's companion spectral
    # radius (None = keep the raw fit, like the reference).  An unstable
    # fitted predictor inside the MPC free response is a positive-feedback
    # path for estimator noise (see var.stabilize).
    var_max_radius: float | None = None
    q_weight: float = 1.5e4            # Q = q*I
    p_weight_scale: float = 1.0        # P(terminal) = scale*Q
    r_weight: float = 1.0              # R = r*I
    u_max: float = 28.0                # input box [rad] (= 200 V)
    du_max: float = 0.2121             # ramp-rate bound [rad]
    x_box: float = 100.0               # fastMPC state box (inactive; README.md:538)
    barrier_k: float = 1e-2            # fixed log-barrier parameter
    newton_steps: int = 1              # fixed Newton step count
    solver: str = "fastmpc"            # fastmpc | fastmpc_ramp | closed_form | admm
    # Acquisition warm start: initialize the DM so the first-step residual
    # is the VAR one-step *prediction error* of the last identification
    # states, not the full turbulence.  The linear estimator's ~1 rad
    # capture range is a cold-start wall at D/r0 >= 10 (|x| ~ 2.6 rad);
    # the ID pre-pass has direct phase access (the reference fits
    # zernmodfit on the true phase, README.md:86-93), so handing the loop
    # over from calibration is physically legitimate -- and once locked,
    # per-step innovations stay inside the capture basin.  False = the
    # reference's cold start (zero DM).
    warm_start: bool = False
    # Estimator-VAR fusion (framework extension; the reference feeds the
    # raw estimate straight into the QP, README.md:483-488).  The loop
    # predicts the current residual from its own state history through the
    # identified VAR model (x_pred = A1(x1 - B u2) + A2(x2 - B u3) + B u1)
    # and blends:  x0 = x_pred + est_gain * clamp(x_est - x_pred).
    # A single out-of-capture PSF estimate (noise spike / strong-turbulence
    # excursion) then cannot eject the loop: the VAR model flywheels
    # through it and the estimator re-acquires once the residual re-enters
    # its capture range.  est_gain=1 with innovation_gate=None is exactly
    # the reference behavior (x0 = x_est).
    est_gain: float = 1.0
    # Norm clamp [rad] on the innovation (None = unbounded).  Set to a few
    # times the expected per-step innovation (VAR prediction error +
    # estimator noise); clamping is disabled on the first var_order+1
    # steps where no state history exists.
    innovation_gate: float | None = None
    # First-step x0_pre: the reference passes zeros (README.md:485-486),
    # which makes the near-double-integrator VAR(2) predict ~2x the state
    # on the cold start and can kick strong-turbulence windows out of the
    # estimator's capture range.  "hold" uses x0_pre=x0 (static-atmosphere
    # assumption); "zero" reproduces the reference.
    cold_start: str = "hold"


@dataclass(frozen=True)
class SimConfig:
    """Closed-loop simulation schedule (reference: README.md:37,112-115,339)."""

    n_train: int = 1000
    n_valid: int = 500
    n_test: int = 500
    d_over_r0: float = 5.0             # effective turbulence strength
    seed: int = 0

    @property
    def n_total(self) -> int:
        return self.n_train + self.n_valid + self.n_test

    @property
    def magnification(self) -> float:
        return mag_conv(self.d_over_r0)


@dataclass(frozen=True)
class SystemConfig:
    """Full system bundle - the unit the pipeline and benchmarks consume."""

    telescope: TelescopeConfig = TelescopeConfig()
    atmosphere: AtmosphereConfig = AtmosphereConfig()
    zernike: ZernikeConfig = ZernikeConfig()
    dm: DMConfig = DMConfig()
    estimator: EstimatorConfig = EstimatorConfig()
    mpc: MPCConfig = MPCConfig()
    sim: SimConfig = SimConfig()

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self) -> int:
        """Unified pupil-plane resolution.

        The reference generates turbulence at 128 px (README.md:54-57) but
        runs the estimator at 512 px (README.md:237); we unify the grids so
        the closed loop is consistent end-to-end (the estimator resolution
        wins).
        """
        return self.estimator.resolution


def reference_config(resolution: int = 128) -> SystemConfig:
    """The reference benchmark scenario at a chosen grid resolution.

    ``resolution=512`` reproduces the reference estimator grid exactly
    (README.md:237); 128 is a faster CPU-testable variant with identical
    structure.
    """
    return SystemConfig(
        telescope=TelescopeConfig(resolution=resolution),
        estimator=EstimatorConfig(resolution=resolution),
    )


def strong_turbulence(cfg: SystemConfig, d_over_r0: float) -> SystemConfig:
    """``cfg`` at D/r0 = ``d_over_r0`` with the strong-turbulence recipe
    (README.md:128-143), as the JAX package's sweep scripts set it up
    (benchmarks/montecarlo_sweep.py:60-67): radial order 10 (65 states),
    the warm start, var_ridge 1e-2, r_weight 30 and the mmse estimator
    with prior_scale min(0.15, 0.5/(D/r0))."""
    return cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=10),
        mpc=dataclasses.replace(cfg.mpc, warm_start=True, var_ridge=1e-2,
                                r_weight=30.0),
        estimator=dataclasses.replace(
            cfg.estimator, method="mmse",
            prior_scale=min(0.15, 0.5 / d_over_r0)),
        sim=dataclasses.replace(cfg.sim, d_over_r0=d_over_r0))
