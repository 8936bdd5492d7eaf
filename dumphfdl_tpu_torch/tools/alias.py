"""Which FCS-failing frames are images of an emitter's frame: the one rule
chip_smoke.py's ledgers, tools/bench.py and tools/soak_stream.py share.

A frame that fails its header FCS is junk: the app counts and drops it.
One kind is expected on bench.py's captures from 1024 channels up.  There
the channels are 3355 Hz apart and each leaves the channelizer at 6750 sps,
so a transmission two channels away (6710 Hz) folds onto a channel 40 Hz
off its centre, through the channel filter's stopband (-76 dB at that
offset).  The capture's noise lies below that: the modulator's 30 dB is per
wideband sample, about 86 dB in a channel's own band at this rate.  So a
quiet channel two from an emitter may lock on the image while the frame
lasts and decode a frame of the emitter's mode that fails its FCS.
ALIAS_STEP names that neighbour; junk anywhere else, at another time or of
another mode is not an image.  (tools/soak_stream.py looks one channel away
too, IMAGE_STEPS.)
"""

from __future__ import annotations

ALIAS_STEP = 2
ALIAS_WINDOW = 64           # symbols around the emitter's frame start


def split_junk(junk, emitters, heard: dict,
               steps: tuple = (ALIAS_STEP,)) -> tuple[list, list]:
    """(alias_at, junk_at): the FCS-failing events `junk`, each as [channel,
    mode, start symbol], split into images and the rest.  An image lies on
    a quiet channel (not in `emitters`) one of `steps` channels from an
    emitter, is of the mode of a frame heard there and starts within
    ALIAS_WINDOW symbols of it.  heard: emitting channel -> [(start symbol,
    mode), ...] of its frames decoded with their bytes.  No steps: no junk
    is an image."""
    alias_at, junk_at = [], []
    for ev in junk:
        near = [] if ev.channel in emitters else [
            h for step in steps for c in (ev.channel - step, ev.channel + step)
            for h in heard.get(c, ())]
        where = [ev.channel, ev.mode, ev.start_symbol]
        if any(abs(ev.start_symbol - s0) <= ALIAS_WINDOW and ev.mode == m0
               for s0, m0 in near):
            alias_at.append(where)
        else:
            junk_at.append(where)
    return alias_at, junk_at
