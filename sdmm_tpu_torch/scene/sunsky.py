"""Hosek-Wilkie sky + Preetham sun baked to an equirect env map (port of
sdmm_tpu/scene/sunsky.py, host-side numpy).

The sky is the Hosek & Wilkie 2012 analytic model on the published ART
coefficients (``sdmm_tpu_torch/data/hosek_rgb.npz``: per channel 9
coefficients + 1 radiance scale on a [2 albedos, 10 turbidities, 6
elevation control points] grid, blended bilinearly in (turbidity, albedo)
and by a quintic Bezier in elevation^(1/3)), divided by the CIE-Y integral
106.856980. The sun is the Preetham et al. 1999 solar spectrum attenuated
by Rayleigh, aerosol, ozone, mixed-gas and water-vapour terms, converted to
RGB by core/spectrum.py and spread over the 0.5358-degree solar disc. Both
are evaluated once on the equirect grid, which the env-map machinery then
reads (bilinear eval, luminance-CDF NEE). The sun's position is an
explicit direction or comes from date, time, latitude and longitude (the
PSA algorithm).
"""

from __future__ import annotations

import os

import numpy as np

SUN_APP_RADIUS_DEG = 0.5358  # reference: sun.cpp:30
SUN_ANGULAR_RADIUS = np.deg2rad(SUN_APP_RADIUS_DEG * 0.5)
CIE_Y_INTEGRAL = 106.856980  # reference: sky.cpp:434

_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "data", "hosek_rgb.npz")
        _DATA = np.load(path)
    return _DATA


def _quintic_bezier(ctrl, x):
    """ctrl [..., 6], x scalar in [0,1] -> quintic Bernstein blend."""
    c = 1.0 - x
    w = np.array([
        c ** 5,
        5.0 * c ** 4 * x,
        10.0 * c ** 3 * x ** 2,
        10.0 * c ** 2 * x ** 3,
        5.0 * c * x ** 4,
        x ** 5,
    ])
    return np.tensordot(ctrl, w, axes=([-1], [0]))


def hosek_state(turbidity: float, albedo, sun_elevation: float):
    """Cook per-channel configuration + radiance scale
    (reference: skymodel.cpp CookConfiguration/CookRadianceConfiguration
    via arhosek_rgb_skymodelstate_alloc_init, :346-374).

    turbidity in [1, 10]; albedo scalar or [3] in [0, 1]; sun_elevation =
    angle ABOVE the horizon in radians. Returns (configs [3, 9],
    radiances [3])."""
    d = _data()
    cfg = d["config"]  # [3, 2, 10, 6, 9]
    rad = d["radiance"]  # [3, 2, 10, 6]
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    alb = np.broadcast_to(np.asarray(albedo, np.float64).reshape(-1), (3,))
    alb = np.clip(alb, 0.0, 1.0)
    it = min(int(turbidity), 10)
    tr = turbidity - it
    x = (max(sun_elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)

    def _b(table, t_idx, a_idx):
        # table [3, 2, 10, 6(, 9)] -> [3(, 9)]: quintic Bezier over the
        # 6 elevation control points at one (albedo, turbidity) corner.
        sub = table[:, a_idx, t_idx]  # [3, 6(, 9)]
        if sub.ndim == 3:
            sub = np.moveaxis(sub, 1, 2)  # [3, 9, 6]
        return _quintic_bezier(sub, x).reshape(3, -1)

    def blend(table):
        out = (1.0 - tr) * ((1.0 - alb)[:, None] * _b(table, it - 1, 0)
                            + alb[:, None] * _b(table, it - 1, 1))
        if it < 10:
            out = out + tr * ((1.0 - alb)[:, None] * _b(table, it, 0)
                              + alb[:, None] * _b(table, it, 1))
        return out

    configs = blend(cfg)  # [3, 9]
    radiances = blend(rad)[:, 0]  # [3]
    return configs, radiances


def hosek_radiance(configs, radiances, theta, gamma):
    """Sky radiance for view zenith angle theta and sun angle gamma
    (reference: skymodel.cpp:226-239 GetRadianceInternal x radiance,
    normalized like sky.cpp:434). theta/gamma broadcast; returns
    [..., 3]."""
    theta = np.asarray(theta)[..., None]
    gamma = np.asarray(gamma)[..., None]
    # Dataset coefficient order is A,B,C,D,E,F,G,I,H: index 7 multiplies the
    # sqrt(cos theta) zenith term and index 8 is the Mie anisotropy
    # (skymodel.cpp GetRadianceInternal uses configuration[7]*zenith and
    # configuration[8] inside the Mie denominator).
    a, b, c, d, e, f, g = (configs[:, k] for k in range(7))
    i, h = configs[:, 7], configs[:, 8]
    cos_t = np.cos(theta)
    cos_g = np.cos(gamma)
    exp_m = np.exp(e * gamma)
    ray_m = cos_g * cos_g
    mie_m = (1.0 + ray_m) / np.power(
        np.maximum(1.0 + h * h - 2.0 * h * cos_g, 1e-12), 1.5
    )
    zenith = np.sqrt(np.maximum(cos_t, 0.0))
    val = (1.0 + a * np.exp(b / (cos_t + 0.01))) * (
        c + d * exp_m + f * ray_m + g * mie_m + i * zenith
    )
    return np.maximum(val * radiances / CIE_Y_INTEGRAL, 0.0)


# --- Preetham sun spectrum (reference: sunmodel.h:252-371) -----------------

_K_O_WL = np.array([
    300, 305, 310, 315, 320, 325, 330, 335, 340, 345,
    350, 355, 445, 450, 455, 460, 465, 470, 475, 480,
    485, 490, 495, 500, 505, 510, 515, 520, 525, 530,
    535, 540, 545, 550, 555, 560, 565, 570, 575, 580,
    585, 590, 595, 600, 605, 610, 620, 630, 640, 650,
    660, 670, 680, 690, 700, 710, 720, 730, 740, 750,
    760, 770, 780, 790], np.float64)
_K_O_AMP = np.array([
    10.0, 4.8, 2.7, 1.35, .8, .380, .160, .075, .04, .019, .007,
    .0, .003, .003, .004, .006, .008, .009, .012, .014, .017,
    .021, .025, .03, .035, .04, .045, .048, .057, .063, .07,
    .075, .08, .085, .095, .103, .110, .12, .122, .12, .118,
    .115, .12, .125, .130, .12, .105, .09, .079, .067, .057,
    .048, .036, .028, .023, .018, .014, .011, .010, .009,
    .007, .004, .0, .0], np.float64)[:64]
_K_G_WL = np.array([759, 760, 770, 771], np.float64)
_K_G_AMP = np.array([0, 3.0, 0.210, 0], np.float64)
_K_WA_WL = np.array([689, 690, 700, 710, 720, 730, 740, 750, 760, 770,
                     780, 790, 800], np.float64)
_K_WA_AMP = np.array([0, 0.160e-1, 0.240e-1, 0.125e-1, 0.100e+1, 0.870,
                      0.610e-1, 0.100e-2, 0.100e-4, 0.100e-4, 0.600e-3,
                      0.175e-1, 0.360e-1], np.float64)
_SOL_WL = np.arange(380, 751, 10, np.float64)
_SOL_AMP = np.array([
    16559.0, 16233.7, 21127.5, 25888.2, 25829.1,
    24232.3, 26760.5, 29658.3, 30545.4, 30057.5,
    30663.7, 28830.4, 28712.1, 27825.0, 27100.6,
    27233.6, 26361.3, 25503.8, 25060.2, 25311.6,
    25355.9, 25134.2, 24631.5, 24173.2, 23685.3,
    23212.1, 22827.7, 22339.8, 21970.2, 21526.7,
    21097.9, 20728.3, 20240.4, 19870.8, 19427.2,
    19072.4, 18628.9, 18259.2], np.float64)


def compute_sun_radiance_rgb(theta_s: float, turbidity: float) -> np.ndarray:
    """Solar disc radiance (RGB) after atmospheric attenuation
    (reference: sunmodel.h:316-371 computeSunRadiance). theta_s = sun
    zenith angle in radians."""
    from ..core.spectrum import interpolated_spectrum_to_rgb

    lam = np.arange(350.0, 801.0, 5.0)  # nm, 91 samples

    def interp(wl, amp):
        return np.interp(lam, wl, amp, left=amp[0], right=amp[-1])

    beta = 0.04608365822050 * turbidity - 0.04586025928522
    theta_deg = np.rad2deg(theta_s)
    m = 1.0 / (np.cos(theta_s) + 0.15 * (93.885 - theta_deg) ** -1.253)

    tau_r = np.exp(-m * 0.008735 * (lam / 1000.0) ** -4.08)
    tau_a = np.exp(-m * beta * (lam / 1000.0) ** -1.3)
    k_o = interp(_K_O_WL, _K_O_AMP)
    tau_o = np.exp(-m * k_o * 0.35)
    k_g = interp(_K_G_WL, _K_G_AMP)
    tau_g = np.exp(-1.41 * k_g * m / (1.0 + 118.93 * k_g * m) ** 0.45)
    k_wa = interp(_K_WA_WL, _K_WA_AMP)
    w = 2.0
    tau_wa = np.exp(
        -0.2385 * k_wa * w * m / (1.0 + 20.07 * k_wa * w * m) ** 0.45
    )
    sol = interp(_SOL_WL, _SOL_AMP)
    spectrum = sol * tau_r * tau_a * tau_o * tau_g * tau_wa
    return np.maximum(interpolated_spectrum_to_rgb(lam, spectrum), 0.0)


def compute_sun_coordinates(year=2010, month=7, day=10, hour=15.0,
                            minute=0.0, second=0.0, timezone=9.0,
                            latitude=35.6894, longitude=139.6917):
    """Sun (zenith angle, azimuth) from date/time/place — the PSA
    algorithm (reference: sunmodel.h:115-204; defaults match the
    reference's Tokyo defaults, sunmodel.h:210-244)."""
    dec_hours = hour - timezone + (minute + second / 60.0) / 60.0
    li_aux1 = (int(month) - 14) // 12
    li_aux2 = (1461 * (int(year) + 4800 + li_aux1)) // 4 \
        + (367 * (int(month) - 2 - 12 * li_aux1)) // 12 \
        - (3 * ((int(year) + 4900 + li_aux1) // 100)) // 4 \
        + int(day) - 32075
    julian = li_aux2 - 0.5 + dec_hours / 24.0
    elapsed = julian - 2451545.0

    omega = 2.1429 - 0.0010394594 * elapsed
    mean_long = 4.8950630 + 0.017202791698 * elapsed
    anomaly = 6.2400600 + 0.0172019699 * elapsed
    ecl_long = mean_long + 0.03341607 * np.sin(anomaly) \
        + 0.00034894 * np.sin(2 * anomaly) - 0.0001134 \
        - 0.0000203 * np.sin(omega)
    ecl_obl = 0.4090928 - 6.2140e-9 * elapsed + 0.0000396 * np.cos(omega)

    sin_el = np.sin(ecl_long)
    ra = np.arctan2(np.cos(ecl_obl) * sin_el, np.cos(ecl_long)) % (2 * np.pi)
    dec = np.arcsin(np.sin(ecl_obl) * sin_el)

    gmst = 6.6974243242 + 0.0657098283 * elapsed + dec_hours
    lmst = np.deg2rad(gmst * 15 + longitude)
    lat = np.deg2rad(latitude)
    ha = lmst - ra
    zenith = np.arccos(np.cos(lat) * np.cos(ha) * np.cos(dec)
                       + np.sin(dec) * np.sin(lat))
    az = np.arctan2(-np.sin(ha),
                    np.tan(dec) * np.cos(lat) - np.sin(lat) * np.cos(ha))
    az = az % (2 * np.pi)
    zenith += (6371.01 / 149597890.0) * np.sin(zenith)
    return float(zenith), float(az)


def sun_coords_to_dir(zenith: float, azimuth: float) -> np.ndarray:
    """(zenith, azimuth) -> direction in the envmap frame (+y up; azimuth 0
    = -z, matching the equirect convention in make_sunsky_envmap)."""
    st = np.sin(zenith)
    return np.array([st * np.sin(azimuth), np.cos(zenith),
                     -st * np.cos(azimuth)])


def _coordinate_system_f32(n):
    """core.frame.coordinate_system of one direction, in float32 (Duff et
    al. 2017)."""
    x, y, z = np.asarray(n, np.float32)
    one = np.float32(1.0)
    sign = one if z >= 0.0 else -one
    a = -one / (sign + z)
    b = x * y * a
    return (np.array([one + sign * x * x * a, sign * b, -sign * x]),
            np.array([b, sign + y * y * a, -y]))


def make_sunsky_envmap(
    sun_dir,
    turbidity: float = 3.0,
    resolution: int = 256,
    with_sky: bool = True,
    with_sun: bool = True,
    sky_scale: float = 1.0,
    sun_scale: float = 1.0,
    albedo=0.15,
    stretch: float = 1.0,
    sun_radius_scale: float = 1.0,
    extend: bool = False,
):
    """Bake the Hosek-Wilkie sky (+ Preetham sun disc) into an equirect
    [H, 2H, 3] map. Directions follow emitters.env_eval's convention:
    row v in [0,1] maps to theta = v*pi from +y (up). Parameters mirror
    the reference plugins (sky.cpp:220-236, sun.cpp:100-143); `extend`
    continues the model below the horizon instead of black."""
    sun_dir = np.asarray(sun_dir, dtype=np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    theta_s = min(theta_s, np.pi / 2 - 1e-3)
    elevation = 0.5 * np.pi - theta_s

    he, we = resolution, 2 * resolution
    v = (np.arange(he) + 0.5) / he
    u = (np.arange(we) + 0.5) / we
    theta = v * np.pi  # from +y
    phi = (u - 0.5) * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack(
        [
            st * np.sin(phi)[None, :],
            np.cos(theta)[:, None] * np.ones((1, we)),
            -st * np.cos(phi)[None, :],
        ],
        axis=-1,
    )
    theta_grid = theta[:, None] * np.ones((1, we))

    out = np.zeros((he, we, 3), np.float32)
    if with_sky:
        configs, radiances = hosek_state(turbidity, albedo, elevation)
        # View angle with optional stretch (sky.cpp:413-421).
        theta_v = theta_grid / stretch
        below = np.cos(theta_v) <= 0
        theta_eval = np.where(below, 0.5 * np.pi - 1e-4, theta_v)
        cos_gamma = np.clip(d @ sun_dir, -1.0, 1.0)
        gamma = np.arccos(cos_gamma)
        sky = hosek_radiance(configs, radiances, theta_eval, gamma)
        if not extend:
            sky = np.where(below[..., None], 0.0, sky)
        out += (sky * sky_scale).astype(np.float32)
    if with_sun and sun_radius_scale > 0.0:
        # QMC cone rasterization (reference: sun.cpp:169-217): deposit the
        # disc's power with stratified samples so total power is
        # resolution-independent.
        radiance = compute_sun_radiance_rgb(theta_s, turbidity) * sun_scale
        cos_cone = np.cos(SUN_ANGULAR_RADIUS * sun_radius_scale)
        solid_angle = 2.0 * np.pi * (1.0 - np.cos(SUN_ANGULAR_RADIUS))
        covered = 0.5 * (1.0 - cos_cone)
        n_samples = int(max(100, he * we * covered * 1000))
        rng = np.random.default_rng(8)
        u1 = (np.arange(n_samples) + rng.random(n_samples)) / n_samples
        u2 = rng.random(n_samples)
        cos_t = 1.0 - u1 * (1.0 - cos_cone)
        sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
        ph = 2.0 * np.pi * u2
        # Frame around the sun direction, built in float32.
        s_ax, t_ax = _coordinate_system_f32(sun_dir)
        dirs = (np.outer(np.cos(ph) * sin_t, s_ax)
                + np.outer(np.sin(ph) * sin_t, t_ax)
                + np.outer(cos_t, sun_dir))
        th = np.arccos(np.clip(dirs[:, 1], -1.0, 1.0))
        az = np.arctan2(dirs[:, 0], -dirs[:, 2]) / (2.0 * np.pi) + 0.5
        iy = np.clip((th / np.pi * he).astype(int), 0, he - 1)
        ix = np.clip((az * we).astype(int), 0, we - 1)
        sin_th = np.maximum(np.sin(th), 1e-3)
        value = radiance * solid_angle * (we * he) / (
            2.0 * np.pi * np.pi * n_samples
        )
        np.add.at(out, (iy, ix), (value[None, :] / sin_th[:, None]).astype(
            np.float32))
    return out
