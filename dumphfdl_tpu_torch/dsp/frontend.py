"""Wideband FFT channelizer: one capture -> N channel streams at 5400 sps.

Counterpart of ``dumphfdl_tpu/dsp/frontend.py``.  The numpy design helpers
(``firdes_*``, ``compute_geometry``, ``plan_channel``, ``_resampler_bank``)
are copied; the streaming path runs on torch tensors:

* overlap-save framing out of a modular wideband ring, batched forward
  FFT (``torch.fft``, complex64);
* per channel a bin-window gather times the pre-shifted kernel window,
  an image fold and one batched inverse FFT of fft_inv_size;
* scrap of the overlap and the residual mixer, appended to the modular
  fs1 ring the fused demod step resamples from (dsp/channel.py).

Ring cursors are host integers (the JAX package carries them on device
and mirrors them on the host; here the host copy is the only one).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import constants as C


def next_pow2(x: int) -> int:
    """Smallest power of two strictly greater than x (libcsdr.c:36-45)."""
    p = 1
    while p <= x:
        p *= 2
    return p


def compute_fft_decimation_rate(sample_rate: int,
                                target_rate: int = C.INTERNAL_RATE) -> int:
    """libcsdr.c:140-144 / main.c:699."""
    return next_pow2(int(sample_rate // target_rate)) // 2


def firdes_filter_len(transition_bw: float) -> int:
    n = int(4.0 / transition_bw)
    return n + 1 if n % 2 == 0 else n


def firdes_lowpass(length: int, cutoff_rate: float) -> np.ndarray:
    """Windowed-sinc lowpass, Hamming window (libcsdr.c:94-108)."""
    middle = length // 2
    i = np.arange(1, middle + 1)
    rate = 0.5 + (i / middle) / 2
    win = 0.54 - 0.46 * np.cos(2 * np.pi * rate)
    taps = np.empty(length, dtype=np.float64)
    taps[middle] = 2 * np.pi * cutoff_rate   # window_function(0) == 1.0
    side = np.sin(2 * np.pi * cutoff_rate * i) / i * win
    taps[middle + 1:] = side
    taps[middle - 1::-1] = side
    return (taps / taps.sum()).astype(np.float64)


def firdes_bandpass_c(length: int, lowcut: float, highcut: float) -> np.ndarray:
    """Complex bandpass: lowpass spectrally shifted (libcsdr.c:110-133)."""
    real = firdes_lowpass(length, (highcut - lowcut) / 2)
    center = (highcut + lowcut) / 2
    phase = 2 * np.pi * center * np.arange(length)
    return (real * np.exp(1j * phase)).astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class DdcGeometry:
    """Overlap-&-scrap geometry (fastddc.c:46-80 with post folded in-band)."""
    decimation: int         # power of two (compute_fft_decimation_rate)
    taps_length: int
    fft_size: int
    overlap_length: int
    input_size: int
    fft_inv_size: int       # fft_size // decimation
    scrap: int
    post_input_size: int
    v: int                  # coarse-shift bin quantum = fft_size // overlap


def compute_geometry(decimation: int, transition_bw: float) -> DdcGeometry:
    taps_min = firdes_filter_len(transition_bw)
    taps_length = next_pow2(-(-taps_min // decimation) * decimation) + 1
    fft_size = next_pow2(taps_length * 4)
    while fft_size < decimation:
        fft_size *= 2
    overlap = taps_length - 1
    input_size = fft_size - overlap
    fft_inv = fft_size // decimation
    v = fft_size // overlap
    scrap = overlap // decimation
    return DdcGeometry(
        decimation=decimation, taps_length=taps_length, fft_size=fft_size,
        overlap_length=overlap, input_size=input_size, fft_inv_size=fft_inv,
        scrap=scrap, post_input_size=fft_inv - scrap, v=v)


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Per-channel downconversion parameters."""
    frequency: int          # Hz (channel frequency, SSB carrier at +1440)
    shift_rate: float       # (centerfreq - (freq+1440)) / fs  (hfdl.c:476)
    coarse_bins: int        # quantized shift, multiple of geometry.v
    residual_cycles: float  # residual shift, cycles per fs1 sample


def plan_channel(geo: DdcGeometry, sample_rate: int, centerfreq: int,
                 frequency: int) -> ChannelPlan:
    shift = (centerfreq - (frequency + C.SSB_CARRIER_OFFSET_HZ)) / sample_rate
    n = geo.fft_size
    b_f = -shift * n
    b = geo.v * int(round(b_f / geo.v))
    db = b_f - b
    residual = db * geo.decimation / n   # cycles per fs1 sample
    return ChannelPlan(frequency=frequency, shift_rate=shift,
                       coarse_bins=b, residual_cycles=residual)


@functools.cache
def _resampler_bank(ratio_x1000: int, ntaps: int, nphases: int = 64) -> np.ndarray:
    """Polyphase windowed-sinc bank for arbitrary-rate conversion (60 dB
    stopband kaiser, cutoff scaled for anti-aliasing, hfdl.c:472)."""
    ratio = ratio_x1000 / 1000.0      # fs_in / fs_out
    cutoff = 0.45 * min(1.0, 1.0 / ratio)
    n = np.arange(ntaps)
    center = ntaps // 2 - 1
    bank = np.zeros((nphases + 1, ntaps), dtype=np.float32)
    win = np.kaiser(ntaps, 7.0)
    for p in range(nphases + 1):
        t = n - (center + p / nphases)
        h = 2 * cutoff * np.sinc(2 * cutoff * t) * win
        bank[p] = h / max(h.sum(), 1e-9)
    return bank


class Channelizer:
    """Streaming wideband -> per-channel converter feeding the fused demod
    step: wideband ring -> overlap-save DDC -> fs1 ring, with the exact
    rational resampler cursor handed to ChannelBank.process_fused."""

    def __init__(self, sample_rate: int, centerfreq: int,
                 frequencies: list[int], device,
                 out_chunk: int = 5400,
                 rows: int | None = None):
        self.device = torch.device(device)
        self.fs = int(sample_rate)
        self.centerfreq = int(centerfreq)
        decimation = compute_fft_decimation_rate(self.fs)
        self.geo = compute_geometry(decimation,
                                    C.CHANNEL_TRANSITION_BW_HZ / self.fs)
        self.fs1 = self.fs / decimation
        self.plans = [plan_channel(self.geo, self.fs, centerfreq, f)
                      for f in frequencies]
        self.num_channels = len(frequencies)
        self.rows = self.num_channels if rows is None else int(rows)
        assert self.rows >= self.num_channels
        self.out_chunk = out_chunk

        geo = self.geo
        # Filter kernels: every channel shares one lowpass prototype, only
        # the spectral shift differs; built in row chunks so the full
        # (rows, fft_size) matrix is never materialized.
        hbw = 0.5 / decimation
        proto = firdes_lowpass(geo.taps_length, hbw)
        centers = -np.asarray([p.shift_rate for p in self.plans], np.float64)
        n_t = np.arange(geo.taps_length)
        self._coarse = np.zeros(self.rows, np.int32)
        self._coarse[:self.num_channels] = [p.coarse_bins for p in self.plans]
        residual64 = np.zeros(self.rows, np.float64)
        residual64[:self.num_channels] = [p.residual_cycles for p in self.plans]

        try:
            from scipy import fft as _sfft
            _fft_rows = lambda a: _sfft.fft(a, n=geo.fft_size, axis=1)
        except ImportError:                     # pragma: no cover
            _fft_rows = lambda a: np.fft.fft(a, n=geo.fft_size, axis=1) \
                .astype(np.complex64)

        def _taps_chunk(i, j):
            return (proto[None, :]
                    * np.exp(2j * np.pi * centers[i:j, None] * n_t[None, :])
                    ).astype(np.complex64)

        chunk = max(1, min(self.num_channels, (64 << 20) // (8 * geo.fft_size)))
        L = geo.fft_inv_size
        n = geo.fft_size
        # smallest even image count whose centred window holds every bin of
        # every channel's kernel FFT above 1e-4 of the peak
        threshold = 1e-4
        w_need = 2
        for i in range(0, self.num_channels, chunk):
            f = _fft_rows(_taps_chunk(i, i + chunk))
            mags = np.abs(f)
            over = mags > threshold * mags.max()
            rows_i, bins = np.nonzero(over)
            rel = (bins - self._coarse[i + rows_i] + n // 2) % n - n // 2
            half = max(int(np.max(rel)) + 1, int(-np.min(rel)))
            w_need = max(w_need, 2 * -(-half // L))
        self.window_images = w = max(2, min(w_need, decimation))
        m = np.arange(w * L)
        idx = (self._coarse[:, None] - (w // 2) * L + m[None, :]) % n
        hwin = np.zeros((self.rows, w * L), np.complex64)
        for i in range(0, self.num_channels, chunk):
            f = _fft_rows(_taps_chunk(i, i + chunk))
            hwin[i:i + chunk] = np.take_along_axis(
                f, idx[i:i + f.shape[0]], axis=1).astype(np.complex64)
        self.tables_from_numpy(idx.astype(np.int32), hwin, residual64)

        # frame-batch cap: per-frame working set is the (B, rows, W)
        # gather + product plus the (B, N) frames/spectrum pair
        budget = 1 << 30
        per_frame = 2 * 8 * self.rows * w * L + 2 * 8 * geo.fft_size
        self._max_frames = max(1, min(64, 1 << int(np.log2(
            max(1, budget // per_frame)))))

        # wideband ring: the largest batch window plus a big upload
        self._rw = 1 << int(np.ceil(np.log2(
            geo.overlap_length + (self._max_frames + 8) * geo.input_size + 1)))
        self._wb_ring = None
        self._wb_fill = geo.overlap_length   # pre-seeded overlap-save tail
        self._wb_wcur = geo.overlap_length
        self._wb_rcur = 0
        self._mixer_phase = torch.zeros(self.rows, dtype=torch.float32,
                                        device=self.device)

        # fs1 ring + resampler: fs1/5400 = fs/(D*5400) as an exact reduced
        # rational num/den, so positions are exact integer arithmetic
        self._out_count = 0            # total 5400-sps samples emitted
        self.ratio = self.fs1 / C.INTERNAL_RATE
        den0 = decimation * C.INTERNAL_RATE
        g = math.gcd(self.fs, den0)
        self._rs_num = self.fs // g
        self._rs_den = den0 // g
        self._rs_exact = (self._rs_den <= (1 << 20)
                          and (out_chunk + 1) * self._rs_num < (1 << 30))
        self._rs_taps = int(8 * max(1, int(np.ceil(self.ratio))))
        self._bank = _resampler_bank(int(round(self.ratio * 1000)),
                                     self._rs_taps)
        need = int(out_chunk * self.ratio) + self._rs_taps \
            + (self._max_frames + 2) * geo.post_input_size + 64
        self._r1 = 1 << int(np.ceil(np.log2(need)))
        self._fs1_ring = None
        self._fs1_wcur = 0
        self._fs1_start = 0            # ring index of _ring_global_start
        self._fs1_fill = 0             # valid samples in the ring
        self._ring_global_start = 0    # global fs1-sample index at _fs1_start
        self._rs_state = None

    def tables_from_numpy(self, idx: np.ndarray, hwin: np.ndarray,
                          residual64: np.ndarray) -> None:
        """Install the channel tables: bin-window indices (rows, W), kernel
        window (rows, W) complex64 and residual mixer rates (rows,) in
        cycles per fs1 sample (float64, used as float32)."""
        self._idx_np = np.asarray(idx, np.int32)
        self._hwin_np = np.asarray(hwin, np.complex64)
        self._residual64 = np.asarray(residual64, np.float64)
        self._idx = torch.as_tensor(self._idx_np.astype(np.int64),
                                    device=self.device)
        self._hwin = torch.as_tensor(self._hwin_np, device=self.device)
        self._residual_dev = torch.as_tensor(
            self._residual64.astype(np.float32), device=self.device)

    def _ensure_rings(self) -> None:
        if self._wb_ring is None:
            self._wb_ring = torch.zeros(self._rw, dtype=torch.complex64,
                                        device=self.device)
            self._fs1_ring = torch.zeros((self.rows, self._r1),
                                         dtype=torch.complex64,
                                         device=self.device)

    def ddc_frames(self, frames: torch.Tensor, phase0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Core DDC on explicit (B, fft_size) overlap-save frames ->
        ((rows, B*post_input_size) fs1 samples, new mixer phase)."""
        geo = self.geo
        w, L, D = self.window_images, geo.fft_inv_size, geo.decimation
        n_frames = frames.shape[0]
        spec = torch.fft.fft(frames, dim=1)                    # (B, N)
        prod = spec[:, self._idx] * self._hwin[None, :, :]     # (B, rows, W)
        folded = prod.reshape(n_frames, self.rows, w, L).sum(dim=2)
        # decimation-in-frequency fold; 1/D matches fastddc.c:194
        time = torch.fft.ifft(folded, dim=2) / D               # (B, rows, L)
        out = time[:, :, geo.scrap:].permute(1, 0, 2).reshape(self.rows, -1)
        # residual mixer: |residual| <= v*D/(2N) cycles/sample, so the
        # float32 ramp stays small over a batch
        n = out.shape[1]
        res = self._residual_dev
        ph = phase0[:, None] + res[:, None] * torch.arange(
            n, dtype=torch.float32, device=frames.device)[None, :]
        out = out * torch.exp((-2j * np.pi) * ph)
        new_phase = torch.remainder(phase0 + res * n, 1.0)
        return out, new_phase

    # ---- streaming API ----

    def ingest(self, samples) -> None:
        """Append wideband samples (numpy, or a tensor already on the
        device) to the wideband ring."""
        self._ensure_rings()
        x = torch.as_tensor(samples, dtype=torch.complex64, device=self.device)
        n = int(x.shape[0])
        if not n:
            return
        if self._wb_fill + n > self._rw:
            raise RuntimeError(
                f'wideband ring overflow: fill {self._wb_fill} + {n} '
                f'> {self._rw} (upload chunk too large for geometry)')
        cols = (self._wb_wcur + torch.arange(n, device=self.device)) % self._rw
        self._wb_ring[cols] = x
        self._wb_wcur = (self._wb_wcur + n) % self._rw
        self._wb_fill += n

    def channelize_available(self) -> None:
        """Channelize every complete frame batch into the fs1 ring."""
        geo = self.geo
        dev = self.device
        while (avail := (self._wb_fill - geo.overlap_length)
                // geo.input_size) > 0:
            n_now = 1 << int(np.log2(min(avail, self._max_frames)))
            n_out = n_now * geo.post_input_size
            if self._fs1_fill + n_out > self._r1:
                raise RuntimeError('fs1 ring overflow (consumer stalled)')
            fr = (self._wb_rcur
                  + torch.arange(n_now, device=dev)[:, None] * geo.input_size
                  + torch.arange(geo.fft_size, device=dev)[None, :]) % self._rw
            out, self._mixer_phase = self.ddc_frames(self._wb_ring[fr],
                                                     self._mixer_phase)
            cols = (self._fs1_wcur
                    + torch.arange(n_out, device=dev)) % self._r1
            self._fs1_ring[:, cols] = out
            self._fs1_wcur = (self._fs1_wcur + n_out) % self._r1
            self._wb_rcur = (self._wb_rcur + n_now * geo.input_size) % self._rw
            self._wb_fill -= n_now * geo.input_size
            self._fs1_fill += n_out

    @property
    def fused_ready(self) -> bool:
        """True when the exact-rational resampler cursor fits int32 (as the
        JAX package requires) and out_chunk is a whole number of cosets:
        the condition for ChannelBank.process_fused."""
        return (bool(self._rs_exact)
                and self._r1 * self._rs_den < (1 << 30)
                and self.out_chunk % self._rs_den == 0)

    def rs_device_state(self) -> tuple[int, int, int]:
        """Resampler cursor (a_frac_num, a_int, rstart) for the fused step;
        created lazily, then advanced through consume_chunk."""
        if self._rs_state is None:
            a_num = (self._out_count * self._rs_num
                     - self._ring_global_start * self._rs_den)
            a_int, a_fnum = divmod(a_num, self._rs_den)
            self._rs_state = (a_fnum, a_int, self._fs1_start)
        return self._rs_state

    def chunk_ready(self) -> bool:
        """Enough fs1 samples buffered for one out_chunk resample?"""
        avail = self._ring_global_start + self._fs1_fill
        last_pos = (self._out_count + self.out_chunk - 1) * self.ratio
        return int(np.floor(last_pos)) + self._rs_taps < avail

    def consume_chunk(self, new_rs_state: tuple[int, int, int]) -> None:
        """Account one fused-step resample: take the advanced cursor and
        free the consumed ring space (the same integer arithmetic as
        channel._rs_advance)."""
        self._rs_state = new_rs_state
        self._out_count += self.out_chunk
        num, den, k = self._rs_num, self._rs_den, self._rs_taps
        a_num = self._out_count * num - self._ring_global_start * den
        a_int = a_num // den
        drop = max(0, min(a_int - k, self._fs1_fill))
        if drop:
            self._fs1_start = (self._fs1_start + drop) % self._r1
            self._fs1_fill -= drop
            self._ring_global_start += drop
