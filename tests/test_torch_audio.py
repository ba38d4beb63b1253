"""The port's audio stack against the JAX package's on the CPU: MP3
``decode_sound`` (``models/sound.py``), the timeline mixer and button
sounds (``runtime/audio.py``), the WAV codec (``utils/wav.py``) and the
CLI's ``--wav``.

Each movie is built once per package on that package's modules
(``tests.test_torch_swf_binary.Kit``; the sound movie from
``swf_renderer_tpu_torch/utils/movie_scenes.py``), parsed and mixed by
that package.  Every comparison is exact: equal arrays with equal dtype
and shape, equal bytes, or the same exception type and message.  The
scenarios are the reference's own (tests/test_sound.py, test_mp3.py):
events, a stream, stop, in / out points and loops, no-multiple,
sprite-local streams, button transitions, MP3 events and streams.
"""

import importlib
import types

import numpy as np
import pytest

from swf_renderer_tpu import __main__ as jcli
from swf_renderer_tpu_torch import __main__ as cli
from swf_renderer_tpu_torch.runtime import movie as tmovie
from swf_renderer_tpu_torch.utils import movie_scenes
from swf_renderer_tpu_torch.utils.png import read_png
from tests.test_torch_mp3 import HOUSE_LO, _grab, assert_same
from tests.test_torch_swf_binary import JAX, PORT, both, kit

RATE = 11025


def mods(k):
    return types.SimpleNamespace(ast=k.ast, fixed=k.fixed, sb=k.sb,
                                 display=k.display, bmp=k.bmp,
                                 sound=k.sound)


def pkg_mod(k, name):
    return importlib.import_module(f"{k.pkg}.{name}")


def _sine(n, freq=440.0, rate=RATE, amp=0.5):
    t = np.arange(n) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None]


def _rect(k):
    return k.ast.Rect(0, 2000, 0, 2000)


def assert_equal_results(got, want):
    """Nested results: arrays equal with dtype and shape, the rest ==."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert_same(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_results(g, w)
    else:
        assert got == want


def _mp3_payload(seek, **kw):
    return seek.to_bytes(2, "little", signed=True) + movie_scenes.mp3_stream(
        **kw)


# ---------------------------------------------------------------------------
# decode_sound: the MP3 branch
# ---------------------------------------------------------------------------

MP3_SOUNDS = {   # name -> (SeekSamples, declared rate, stream keywords)
    "seek-resample": (100, 22050, dict(n=10, version=2, mode=3,
                                       rate_index=1, seed=3)),
    "seek-same-rate": (576, 44100, dict(n=6, version=3, mode=1, seed=4)),
    "negative-seek": (-7, 11025, dict(n=8, version=0, mode=0, seed=5,
                                      id3=True)),
    "no-declared-rate": (0, None, dict(n=8, version=2, mode=2,
                                       rate_index=2, seed=6)),
}


@pytest.mark.parametrize("name", list(MP3_SOUNDS))
def test_decode_sound_mp3_equal(name):
    """SeekSamples trims the decode's head, then the PCM is resampled
    from the MPEG frames' rate to the declared one; ``sample_count``
    trims the tail."""
    seek, declared, kw = MP3_SOUNDS[name]
    data = _mp3_payload(seek, **kw)

    def build(k, rng):
        s = k.sound
        return [s.decode_sound(s.FORMAT_MP3, data, 16, 2,
                               declared_rate=declared),
                s.decode_sound(s.FORMAT_MP3, data, 16, 2, sample_count=777,
                               declared_rate=declared),
                s._linear_resample(_sine(301), 24000, 22050)]

    want, got = both(build)
    assert_equal_results(got, want)
    assert got[1].shape[0] == 777


def test_sound_refusals_agree():
    """Nellymoser and unknown formats refuse as the reference does; a
    payload that holds no MPEG frame raises its ValueError."""
    def build(k, rng):
        s = k.sound
        return [_grab(lambda: s.decode_sound(s.FORMAT_NELLYMOSER, b"\x00",
                                             16, 1)),
                _grab(lambda: s.decode_sound(9, b"\x00" * 8, 16, 1)),
                _grab(lambda: s.decode_sound(s.FORMAT_MP3, b"\x00" * 64, 16,
                                             1, declared_rate=22050))]

    want, got = both(build)
    assert got == want
    assert [g[0] for g in got] == ["NotImplementedError",
                                   "NotImplementedError", "ValueError"]


# ---------------------------------------------------------------------------
# The mixer on the reference's scenarios
# ---------------------------------------------------------------------------


def mixer_events_and_stream(k, rng):
    s = k.sound
    snd = s.Sound(id=1, format=s.FORMAT_UNCOMPRESSED_LE, rate=RATE, bits=16,
                  channels=1, sample_count=500,
                  data=s.encode_uncompressed(_sine(500), 16))
    stream = s.SoundStream(format=s.FORMAT_UNCOMPRESSED_LE, rate=RATE,
                           bits=16, channels=1, samples_per_frame=1102)
    stream.blocks[1] = s.encode_uncompressed(_sine(1102, 660, amp=0.2), 16)
    events = {0: [(1, s.SoundInfo())], 2: [(1, s.SoundInfo())]}
    return k.sb.emit_movie_timeline(
        frames=[[], [], [], []], sounds=(snd,), sound_events=events,
        sound_stream=stream, stage_rect=_rect(k), frame_rate=10.0)


def mixer_stop_truncates(k, rng):
    s = k.sound
    snd = s.Sound(id=1, format=s.FORMAT_UNCOMPRESSED_LE, rate=RATE, bits=16,
                  channels=1, sample_count=9000,
                  data=s.encode_uncompressed(_sine(9000), 16))
    events = {0: [(1, s.SoundInfo())], 1: [(1, s.SoundInfo(stop=True))]}
    return k.sb.emit_movie_timeline(
        frames=[[], [], []], sounds=(snd,), sound_events=events,
        stage_rect=_rect(k), frame_rate=10.0)


def mixer_adpcm_points_loops(k, rng):
    """The reference's wire case (in / out points, loops, stop) mixed,
    with a no-multiple retrigger while the first instance rings."""
    s = k.sound
    pcm = np.concatenate([_sine(800), _sine(800, 997, amp=0.3)], axis=1)
    snd = s.Sound(id=3, format=s.FORMAT_ADPCM, rate=RATE, bits=16,
                  channels=2, sample_count=800, data=s.encode_adpcm(pcm))
    events = {0: [(3, s.SoundInfo())],
              1: [(3, s.SoundInfo(no_multiple=True))],
              2: [(3, s.SoundInfo(loops=3, in_point=100, out_point=700))],
              3: [(3, s.SoundInfo(stop=True))]}
    return k.sb.emit_movie_timeline(
        frames=[[], [], [], [], []], sounds=(snd,), sound_events=events,
        stage_rect=_rect(k), frame_rate=10.0)


def mixer_sprite_stream(k, rng):
    s = k.sound
    stream = s.SoundStream(format=s.FORMAT_UNCOMPRESSED_LE, rate=RATE,
                           bits=16, channels=1, samples_per_frame=1102)
    stream.blocks[0] = s.encode_uncompressed(_sine(1102, 660, amp=0.3), 16)
    frames = [[], [], [k.sb.Placement(depth=1, character_id=7)], []]
    return k.sb.emit_movie_timeline(frames, sprites=[(7, [[], []], stream)],
                                    stage_rect=_rect(k), frame_rate=10.0)


def mixer_mp3_event_and_stream(k, rng):
    """An MP3 DefineSound (MPEG-2 at 16 kHz declared 11.025 kHz: two
    resamples) and an MP3 stream whose blocks split the MPEG frames
    (the bit reservoir crosses the blocks), SeekSamples on both."""
    s = k.sound
    snd = s.Sound(id=2, format=s.FORMAT_MP3, rate=RATE, bits=16, channels=1,
                  sample_count=4000,
                  data=_mp3_payload(50, n=10, version=2, mode=3,
                                    rate_index=2, seed=8))
    frames = movie_scenes.mp3_frames(12, version=0, mode=1, rate_index=0,
                                     seed=9)
    stream = s.SoundStream(format=s.FORMAT_MP3, rate=RATE, bits=16,
                           channels=2, samples_per_frame=1102)
    for f, (a, b) in enumerate(((0, 5), (5, 9), (9, 12))):
        stream.blocks[f] = ((b - a) * 576).to_bytes(2, "little") + (
            (33 if f == 0 else 0).to_bytes(2, "little")) + b"".join(
                frames[a:b])
    return k.sb.emit_movie_timeline(
        frames=[[], [], [], []], sounds=(snd,),
        sound_events={1: [(2, s.SoundInfo(loops=2))]}, sound_stream=stream,
        stage_rect=_rect(k), frame_rate=10.0)


def mixer_house_lo(k, rng):
    """The reference's DefineSound MP3 case on its fixture."""
    s = k.sound
    mp3 = HOUSE_LO.read_bytes()
    snd = s.Sound(id=1, format=s.FORMAT_MP3, rate=RATE, bits=16, channels=1,
                  sample_count=70000, data=(0).to_bytes(2, "little") + mp3)
    return k.sb.emit_movie_timeline(
        frames=[[], []], sounds=(snd,),
        sound_events={0: [(1, s.SoundInfo())]}, stage_rect=_rect(k),
        frame_rate=10.0)


def sound_movie(k, rng):
    return movie_scenes.sound_movie(mods(k), 96, 64, frames=8)[0]


MIXES = {f.__name__: f for f in (
    mixer_events_and_stream, mixer_stop_truncates, mixer_adpcm_points_loops,
    mixer_sprite_stream, mixer_mp3_event_and_stream, mixer_house_lo,
    sound_movie)}


@pytest.mark.parametrize("name", list(MIXES))
def test_mix_movie_audio_equal(name):
    """The same movie bytes from both packages' emitters, each parsed and
    mixed by its package at the reference's scenario rate and at 44.1
    kHz, and with the timeline cut to its first frames."""
    if name == "mixer_house_lo" and not HOUSE_LO.exists():
        pytest.skip("fixture absent")

    def build(k, rng):
        data = MIXES[name](k, rng)
        movie = k.sb.parse_movie(data)
        audio = pkg_mod(k, "runtime.audio")
        return [data, audio.mix_movie_audio(movie, rate=RATE),
                audio.mix_movie_audio(movie),
                audio.mix_movie_audio(movie, n_frames=2, rate=22050)]

    want, got = both(build)
    assert got[0] == want[0]
    assert_equal_results(got[1:], want[1:])
    assert got[1].dtype == np.float32 and got[1].shape[1] == 2
    assert np.abs(got[2]).max() > 0.05


def test_sound_movie_tracks():
    """``sound_movie``'s soundtrack parses to what it was built from: an
    MP3 stream with one block a frame, two sounds, four StartSounds."""
    data, stages = movie_scenes.sound_movie(movie_scenes.port_mods(), 96,
                                            64, frames=12)
    k = kit(PORT)
    m = k.sb.parse_movie(data)
    assert len(stages) == len(m.frames) == 12
    assert m.frame_rate == movie_scenes.SOUND_FPS
    st = m.sound_stream
    assert (st.format, st.rate, st.channels) == (k.sound.FORMAT_MP3, 44100,
                                                 2)
    assert sorted(st.blocks) == list(range(12))
    assert {s.id: s.format for s in m.sounds.values()} == {
        30: k.sound.FORMAT_ADPCM, 31: k.sound.FORMAT_MP3}
    assert sum(len(v) for v in m.sound_events.values()) == 4


def button_movie(k, rng):
    s, sb = k.sound, k.sb
    pcm = _sine(600)
    snd = s.Sound(id=4, format=s.FORMAT_UNCOMPRESSED_LE, rate=RATE, bits=16,
                  channels=1, sample_count=600,
                  data=s.encode_uncompressed(pcm, 16))
    mp3 = s.Sound(id=5, format=s.FORMAT_MP3, rate=22050, bits=16,
                  channels=1, sample_count=3000,
                  data=_mp3_payload(20, n=6, version=2, mode=3,
                                    rate_index=1, seed=11))
    button = sb.Button(id=9, records=(
        sb.ButtonRecord(character_id=4, depth=1, matrix=k.mat(),
                        states=0x01),))
    slots = (None, (4, s.SoundInfo(loops=2)),
             (5, s.SoundInfo(in_point=100, out_point=2400)),
             (4, s.SoundInfo(stop=True)))
    return sb.emit_movie_timeline(
        frames=[[]], sounds=(snd, mp3), buttons=(button,),
        button_sounds={9: slots}, stage_rect=_rect(k), frame_rate=10.0)


def test_button_transition_pcm_equal():
    """Every transition of the reference's button case (a silent slot, a
    loop, in / out points on an MP3 sound, a stop) at two rates, twice
    (each call decodes anew, as in the reference), a missing button and
    an unknown transition."""
    def build(k, rng):
        audio = pkg_mod(k, "runtime.audio")
        movie = k.sb.parse_movie(button_movie(k, rng))
        out = []
        for transition in k.sb.BUTTON_SOUND_TRANSITIONS:
            for rate in (RATE, 44100, RATE):
                out.append(audio.button_transition_pcm(movie, 9, transition,
                                                       rate=rate))
        out.append(audio.button_transition_pcm(movie, 1, "idle_to_over_up"))
        out.append(_grab(lambda: audio.button_transition_pcm(movie, 9,
                                                             "hover")))
        return out

    want, got = both(build)
    assert_equal_results(got, want)
    assert got[0] is None and got[9].shape == (0, 2)
    assert got[-1][0] == "ValueError"


# ---------------------------------------------------------------------------
# WAV and the CLI
# ---------------------------------------------------------------------------


def test_wav_round_trips_equal():
    """``wav_bytes`` of mono, stereo, 1-D and out-of-range PCM at three
    rates; ``read_wav`` of each; ``write_wav``; the refusals."""
    from swf_renderer_tpu.utils import wav as jwav
    from swf_renderer_tpu_torch.utils import wav as twav

    rng = np.random.default_rng(2)
    pcms = [np.concatenate([_sine(300), _sine(300, 880)], axis=1),
            _sine(257, 97.0), rng.uniform(-1.5, 1.5, 400).astype(np.float32),
            rng.uniform(-1, 1, (0, 2)).astype(np.float64)]
    for pcm in pcms:
        for rate in (11025, 22050, 44100):
            got, want = twav.wav_bytes(pcm, rate), jwav.wav_bytes(pcm, rate)
            assert got == want
            back = twav.read_wav(got)
            assert_equal_results(back, jwav.read_wav(want))
            assert back[1] == rate
    riff = twav.wav_bytes(pcms[0])
    for bad in (b"RIFX" + riff[4:], riff[:20] + b"\x08" + riff[21:],
                riff.replace(b"fmt ", b"fmx ")):
        got = _grab(lambda: twav.read_wav(bad))
        assert got == _grab(lambda: jwav.read_wav(bad))
        assert got[0] == "ValueError"


def test_write_wav_and_mix_movie_audio_export(tmp_path):
    import swf_renderer_tpu_torch as tswf
    from swf_renderer_tpu_torch.runtime import audio
    from swf_renderer_tpu_torch.utils import wav as twav

    assert tswf.mix_movie_audio is audio.mix_movie_audio
    pcm = np.concatenate([_sine(300), _sine(300, 880)], axis=1)
    twav.write_wav(tmp_path / "a.wav", pcm, 22050)
    assert (tmp_path / "a.wav").read_bytes() == twav.wav_bytes(pcm, 22050)


@pytest.fixture(scope="module")
def sound_swf(tmp_path_factory):
    p = tmp_path_factory.mktemp("audio") / "sound.swf"
    p.write_bytes(movie_scenes.sound_movie(movie_scenes.port_mods(), 96, 64,
                                           frames=6)[0])
    return p


def test_cli_wav_writes_the_references_bytes(sound_swf, tmp_path, capsys):
    """Audio only: both CLIs mix, write the WAV, print its path and
    render nothing."""
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    assert cli.main([str(sound_swf), "--wav", str(a)], device="cpu") == 0
    assert capsys.readouterr().out.strip() == str(a)
    assert jcli.main([str(sound_swf), "--wav", str(b)]) == 0
    assert capsys.readouterr().out.strip() == str(b)
    assert a.read_bytes() == b.read_bytes()
    assert not sound_swf.with_suffix(".swf.png").exists()


def test_cli_wav_with_frames_renders_too(sound_swf, tmp_path, capsys):
    """``--wav`` with ``--frames``: the WAV, then the timeline's PNGs
    equal to the in-process render."""
    wav = tmp_path / "out.wav"
    frames_dir = tmp_path / "frames"
    assert cli.main([str(sound_swf), "--wav", str(wav), "--frames",
                     str(frames_dir)], device="cpu") == 0
    assert capsys.readouterr().out.split() == [str(wav), str(frames_dir)]
    want = tmovie.render_movie_timeline(sound_swf, device="cpu")
    pngs = sorted(frames_dir.glob("*.png"))
    assert len(pngs) == want.shape[0] == 6
    for p, f in zip(pngs, want):
        assert np.array_equal(read_png(p), f)
    k = kit(JAX)
    ref = pkg_mod(k, "utils.wav").wav_bytes(pkg_mod(
        k, "runtime.audio").mix_movie_audio(
            k.sb.parse_movie(sound_swf.read_bytes())))
    assert wav.read_bytes() == ref
