"""The exact ledger and the alias rule against hand-built frame lists."""

from hfdlbench import ledger, tx

SLOTS = 2
S = tx.SLOT_SYMBOLS
PDU0, PDU8 = b'\x01\x02\x03' * 4, b'\x04\x05\x06' * 4
SENT = [tx.Emission(channel=0, hz=0, slot=0, mode=1, pdu=PDU0, snr_db=20.0,
                    delay_s=0.01),
        tx.Emission(channel=8, hz=0, slot=1, mode=2, pdu=PDU8, snr_db=20.0,
                    delay_s=0.02)]
OFF = 30                        # the tracker's start, after the frame's


def d(ch, mode, start, pdu, ok=True):
    return ledger.Decoded(channel=ch, mode=mode, start_symbol=start,
                          pdu=pdu, fcs_ok=ok)


def start(e, loop):
    return int(loop * SLOTS * S + e.start_symbol) + OFF


def exact(loops=2):
    return [d(e.channel, e.mode, start(e, k), e.pdu + b'\x00')
            for k in range(loops) for e in SENT]


def settle(frames, loops=2):
    return ledger.settle(frames, SENT, SLOTS, loops)


def test_exact_ledger():
    led = settle(exact())
    assert (led['missing'], led['duplicate'], led['other'],
            led['junk_at']) == ([], 0, [], [])
    assert led['expected'] == 4
    assert sorted(led['cells']) == [(0, 0), (0, 2), (8, 1), (8, 3)]
    assert [round(x) for x in led['start_offsets']] == [OFF, OFF]


def test_missing_duplicate_and_wrong_bytes():
    frames = exact()
    led = settle(frames[1:] + [frames[2]])
    assert led['missing'] == [[0, 0]] and led['duplicate'] == 1
    bad = exact()
    bad[3] = d(8, 2, bad[3].start_symbol, b'\x04\x05\x07' * 4)
    led = settle(bad)
    assert led['missing'] == [[8, 3]] and len(led['other']) == 1


def test_frames_outside_the_loops_slots_or_start_slack_are_other():
    late = exact() + [d(0, 1, start(SENT[0], 2), PDU0)]
    assert len(settle(late)['other']) == 1
    wrong_slot = exact() + [d(0, 1, start(SENT[0], 0) + S, PDU0)]
    assert len(settle(wrong_slot)['other']) == 1
    off = exact()
    off[0] = d(0, 1, start(SENT[0], 0) + ledger.START_SLACK + 1, PDU0)
    led = settle(off)
    assert len(led['other']) == 1 and led['missing'] == [[0, 0]]
    quiet = exact() + [d(3, 1, start(SENT[0], 0), PDU0)]   # an FCS pass
    assert settle(quiet)['other'][0][:2] == [3, 1]


def test_only_the_alias_rule_excuses_junk():
    frames = exact()
    s0 = frames[0].start_symbol                     # channel 0, slot 0
    image = d(2, 1, s0 + 10, b'junk', ok=False)     # 2 from ch 0
    near = d(1, 1, s0 - 64, b'junk', ok=False)      # 1 from ch 0
    mode = d(1, 3, s0, b'junk', ok=False)           # another mode
    late = d(2, 1, s0 + 65, b'junk', ok=False)      # too late
    far = d(3, 1, s0, b'junk', ok=False)            # 3 from ch 0
    own = d(8, 1, s0, b'junk', ok=False)            # on an emitter? no:
    # channel 8 sends in slot 1 only, so in slot 0 it is quiet, 8 away
    emitter = d(0, 1, s0 + 5, b'junk', ok=False)    # ch 0 itself
    led = settle(frames + [image, near, mode, late, far, own, emitter])
    assert sorted(a[0] for a in led['alias_at']) == [1, 2]
    assert sorted(j[0] for j in led['junk_at']) == [0, 1, 2, 3, 8]
    assert led['missing'] == [] and led['other'] == []
