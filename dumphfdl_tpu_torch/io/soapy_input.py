# Copy of dumphfdl_tpu/io/soapy_input.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""SoapySDR live input (gated on the SoapySDR python module).

Reference behavior: reference src/input-soapysdr.c -- device
enumeration, sample rate / center freq / PPM / gain / antenna /
device-settings configuration, automatic DC offset correction
(input-soapysdr.c:111-115), **native-format negotiation** among
CU8/CS16/CF32 (soapysdr_choose_sample_format, input-soapysdr.c:49-83:
prefer the device's native format to halve USB bandwidth, fall back to
the first supported format in the device list), per-device full-scale
conversion (input-helpers.c:10-78), and exit after 5 consecutive read
errors so a supervisor (systemd Restart=on-failure) restarts the process.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

SOAPY_READ_ERROR_LIMIT = 5     # input-soapysdr.c:224

# format name -> (numpy element dtype, elements per complex sample)
_SUPPORTED = {
    'CU8': (np.uint8, 2),
    'CS16': (np.int16, 2),
    'CF32': (np.float32, 2),
}
# assumed full scale when the device doesn't report one
# (input-helpers.c sample_format_params)
_DEFAULT_FULL_SCALE = {'CU8': 127.0, 'CS16': 32767.5, 'CF32': 1.0}


@dataclasses.dataclass
class SoapyInput:
    device: str
    sample_rate: int
    centerfreq: int
    gain: float | None = None
    gain_elements: dict | None = None
    freq_correction: float = 0.0
    antenna: str | None = None
    device_settings: dict | None = None
    sample_format: str | None = None    # force a format; None = negotiate
    buffer_samples: int = 65536

    # populated by connect():
    negotiated_format: str | None = None
    full_scale: float = 1.0

    def _import_soapy(self):
        try:
            import SoapySDR
            return SoapySDR
        except ImportError:
            raise SystemExit(
                'SoapySDR python bindings are not installed; '
                'use --iq-file or install SoapySDR') from None

    def _choose_format(self, dev, RX) -> tuple[str, float]:
        """Native-format negotiation (input-soapysdr.c:49-83)."""
        if self.sample_format:
            fmt = self.sample_format.upper()
            if fmt not in _SUPPORTED:
                raise SystemExit(f'soapysdr: unsupported sample format {fmt}')
            return fmt, _DEFAULT_FULL_SCALE[fmt]
        try:
            native, fullscale = dev.getNativeStreamFormat(RX, 0)
            native = str(native).upper()
            if native in _SUPPORTED and fullscale > 0:
                print(f'soapysdr: using native sample format {native} '
                      f'(full_scale: {fullscale:.3f})', file=sys.stderr)
                return native, float(fullscale)
        except Exception:
            native = None
        try:
            for fmt in dev.getStreamFormats(RX, 0):
                fmt = str(fmt).upper()
                if fmt in _SUPPORTED:
                    print(f'soapysdr: using non-native sample format {fmt} '
                          f'(assuming full_scale='
                          f'{_DEFAULT_FULL_SCALE[fmt]:.3f})', file=sys.stderr)
                    return fmt, _DEFAULT_FULL_SCALE[fmt]
        except Exception:
            pass
        return 'CF32', 1.0

    @property
    def is_integer_format(self) -> bool:
        """True when the stream is integer-quantized at the source, so the
        CS16-packed device upload loses nothing (app.run_stream packed=)."""
        return (self.negotiated_format or 'CF32') != 'CF32'

    def connect(self):
        """Open + configure the device and negotiate the stream format.
        Returns self (so cli can read negotiated_format before streaming)."""
        SoapySDR = self._import_soapy()
        RX = SoapySDR.SOAPY_SDR_RX
        dev = SoapySDR.Device(self.device)
        dev.setSampleRate(RX, 0, float(self.sample_rate))
        dev.setFrequency(RX, 0, float(self.centerfreq))
        if self.freq_correction:
            dev.setFrequencyCorrection(RX, 0, self.freq_correction)
        if self.antenna:
            dev.setAntenna(RX, 0, self.antenna)
        if self.gain is not None:
            dev.setGainMode(RX, 0, False)
            dev.setGain(RX, 0, float(self.gain))
        elif self.gain_elements:
            dev.setGainMode(RX, 0, False)
            for name, value in self.gain_elements.items():
                dev.setGain(RX, 0, name, float(value))
        else:
            dev.setGainMode(RX, 0, True)   # AGC if supported
        # automatic DC offset correction (input-soapysdr.c:111-115)
        try:
            if dev.hasDCOffsetMode(RX, 0):
                dev.setDCOffsetMode(RX, 0, True)
        except Exception as e:
            print(f'soapysdr: setDCOffsetMode failed: {e}', file=sys.stderr)
        for key, value in (self.device_settings or {}).items():
            dev.writeSetting(key, value)
        self.negotiated_format, self.full_scale = self._choose_format(dev, RX)
        self._dev = dev
        self._RX = RX
        return self

    def _convert(self, raw: np.ndarray, n_samples: int) -> np.ndarray:
        """Raw interleaved elements -> normalized complex64
        (input-helpers.c:10-78 with the negotiated full scale)."""
        fmt = self.negotiated_format
        v = raw[:2 * n_samples].astype(np.float32)
        fs = np.float32(self.full_scale)
        if fmt == 'CU8':
            v = (v - fs / 2) / fs
        elif fs != 1.0:
            v = v / fs
        out = np.empty(n_samples, np.complex64)
        out.real = v[0::2]
        out.imag = v[1::2]
        return out

    def stream(self):
        """Yield normalized complex64 chunks; call connect() first (the
        cli does; calling stream() directly connects lazily)."""
        if getattr(self, '_dev', None) is None:
            self.connect()
        SoapySDR = self._import_soapy()
        dev, RX = self._dev, self._RX
        fmt = self.negotiated_format
        dtype, _ = _SUPPORTED[fmt]
        soapy_fmt = {'CU8': getattr(SoapySDR, 'SOAPY_SDR_CU8', 'CU8'),
                     'CS16': SoapySDR.SOAPY_SDR_CS16,
                     'CF32': SoapySDR.SOAPY_SDR_CF32}[fmt]
        st = dev.setupStream(RX, soapy_fmt)
        dev.activateStream(st)
        buf = np.empty(2 * self.buffer_samples, dtype=dtype)
        errors = 0
        try:
            while True:
                sr = dev.readStream(st, [buf], self.buffer_samples,
                                    timeoutUs=1_000_000)
                if sr.ret > 0:
                    errors = 0
                    yield self._convert(buf, sr.ret)
                else:
                    errors += 1
                    print(f'soapysdr: read error {sr.ret} '
                          f'({errors}/{SOAPY_READ_ERROR_LIMIT})',
                          file=sys.stderr)
                    if errors >= SOAPY_READ_ERROR_LIMIT:
                        # exit nonzero so a supervisor restarts us
                        raise SystemExit(1)
        finally:
            dev.deactivateStream(st)
            dev.closeStream(st)
