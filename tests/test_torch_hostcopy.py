"""The port's own copies of the host layers (vorbis_tpu_torch/bitstream,
codec, models/encsetup+modes, ops/psy+window+mdct+envelope, the
ReservoirChooser of ops/managed, utils/scales, data/) against the
originals in vorbis_tpu, and the port's host C (csrc/host_ogg.c: the Ogg
CRC against the Python loop, the stretch-rescue walk against vorbis_tpu's
native/vorbisnative.c vn_rescue_walk; csrc/host_decode.c function by
function against native/vorbisnative.c), with the decode slice's copies
(codec/floor0_codec.py, codec/nativeparse.py, the copied functions of
models/fastdec.py, FastStreamDecoder and vorbisfile.py but for their
device lines) and the training slice's (vq/huffbuild.py,
vq/latticebuild.py, vq/training.py, lbg_train's host loop but for its
device lines, TorchCodecPipeline.frame, local_book_besterror) and the
golden encoder's (codec/encoder.py, ops/psy.py, ops/envelope.py,
ops/rdft.py, ops/window.py, utils/analysis_dump.py and the encode
halves of codec/floor1_codec.py and codec/residue_codec.py: whole files
but for COPY_LINES; the numpy todB_np and unitnorm_np of
utils/scales.py).  numpy only: every comparison is exact (bytes,
integers, float32 arrays bit for bit)."""

import filecmp
import os
import re

import numpy as np
import pytest

import vorbis_tpu.bitstream.oggfile as J_ogg
import vorbis_tpu.codec.decoder as J_dec
import vorbis_tpu.codec.encoder as J_enc
import vorbis_tpu.models.encsetup as J_setup
import vorbis_tpu.native as J_native
import vorbis_tpu.ops.envelope as J_env
import vorbis_tpu.ops.mdct as J_mdct
import vorbis_tpu_torch.bitstream.oggfile as T_ogg
import vorbis_tpu_torch.codec.decoder as T_dec
import vorbis_tpu_torch.codec.encoder as T_enc
import vorbis_tpu_torch.models.encsetup as T_setup
import vorbis_tpu_torch.ops.envelope as T_env
import vorbis_tpu_torch.ops.mdct as T_mdct
from tests import oracle
from vorbis_tpu.vorbisfile import OggVorbisFile
from vorbis_tpu_torch.models.fastenc import FastEncoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = ("books.npz", "books_meta.json.gz", "floor_tables.npz",
        "modes.json.gz", "psy_tables.npz", "windows.npz")
CONFIGS = [(2, 44100, 0.5), (2, 44100, -0.1), (1, 8000, 0.2),
           (6, 48000, 0.4)]


def _same(a, b):
    """Equal values, types and shapes, arrays bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _book_fields(book):
    if book is None:
        return None
    return (book.dim, book.entries, book.codewords, book.lengths,
            book.values)


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{c}ch-{r}-q{q}" for c, r, q in CONFIGS])
def encoders(request):
    ch, rate, q = request.param
    return (J_enc.Encoder(J_setup.setup_vbr(ch, rate, q)),
            T_enc.Encoder(T_setup.setup_vbr(ch, rate, q)))


def test_data_files_are_byte_copies():
    for name in DATA:
        assert filecmp.cmp(os.path.join(ROOT, "vorbis_tpu", "data", name),
                           os.path.join(ROOT, "vorbis_tpu_torch", "data",
                                        name), shallow=False), name


def test_header_packets_byte_equal(encoders):
    je, te = encoders
    jh, th = je.header_packets(), te.header_packets()
    assert len(th) == 3 and all(a == b for a, b in zip(jh, th))
    assert je.header_packets(["A=b"]) == te.header_packets(["A=b"])


def test_floor_and_residue_looks_equal(encoders):
    je, te = encoders
    assert len(je.floor_looks) == len(te.floor_looks) > 0
    for jl, tl in zip(je.floor_looks, te.floor_looks):
        assert _same(vars(jl.info), vars(tl.info))
        for k in ("posts", "n", "quant_q", "forward_index", "sorted_x",
                  "loneighbor", "hineighbor"):
            assert _same(getattr(jl, k), getattr(tl, k)), k
    assert len(je.residue_looks) == len(te.residue_looks) > 0
    for jl, tl in zip(je.residue_looks, te.residue_looks):
        assert _same(vars(jl.info), vars(tl.info))
        for k in ("dim", "partvals", "decodemap", "stages"):
            assert _same(getattr(jl, k), getattr(tl, k)), k
        assert _same(_book_fields(jl.phrasebook),
                     _book_fields(tl.phrasebook))
        assert _same([list(map(_book_fields, r)) for r in jl.partbooks],
                     [list(map(_book_fields, r)) for r in tl.partbooks])


def test_psy_looks_equal(encoders):
    je, te = encoders
    assert len(je.psy_looks) == len(te.psy_looks) > 0
    for jl, tl in zip(je.psy_looks, te.psy_looks):
        jv, tv = vars(jl), vars(tl)
        assert jv.keys() == tv.keys()
        for k in jv:
            assert _same(jv[k], tv[k]), k


@pytest.mark.parametrize("n", [256, 2048])
def test_mdct_and_imdct_bitwise(n):
    rng = np.random.RandomState(n)
    x = rng.randn(4, n).astype(np.float32)
    spec = rng.randn(4, n // 2).astype(np.float32)
    assert _same(T_mdct.mdct_forward(x, n), J_mdct.mdct_forward(x, n))
    assert _same(T_mdct.imdct(spec, n), J_mdct.imdct(spec, n))


# The lines by which the golden encoder's host copies differ from their
# sources ("-" the source's, "+" the port's), besides the paragraph each
# adds to its module docstring: the numpy todB and unitnorm take their
# own names in the port's utils/scales.py (its todB and unitnorm are on
# torch tensors), and the port's codebook decodes a run in Python (no
# native decoder).
COPY_LINES = {
    "codec/encoder.py": [
        "- from ..utils.scales import todB",
        "+ from ..utils.scales import todB_np as todB"],
    "codec/floor1_codec.py": [],
    "codec/residue_codec.py": [
        '-     same-book codewords decodes in one native call."""',
        '+     same-book codewords decodes in one decode_run call."""'],
    "ops/envelope.py": [
        "- from ..utils.scales import todB",
        "+ from ..utils.scales import todB_np as todB"],
    "ops/psy.py": [
        "- from ..utils.scales import fromOC, toBARK, toOC, unitnorm",
        "+ from ..utils.scales import fromOC, toBARK, toOC, unitnorm_np as "
        "unitnorm"],
    "ops/rdft.py": [],
    "ops/window.py": [],
    "utils/analysis_dump.py": [],
}


def _copy_and_note(rel):
    """(source text, port text without the paragraph it adds to its
    module docstring, that paragraph)."""
    src, port = (open(os.path.join(ROOT, pkg, *rel.split("/"))).read()
                 for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    i = port.index("\n\nCopy of vorbis_tpu/" + rel)
    j = port.index('"""', i)
    para = port[i + 2:j].rstrip("\n")
    # the source closes its docstring on a line of its own or after text
    own = port[:i] + "\n" + port[j:]
    return src, own if src.startswith(port[:i] + '\n"""') else \
        port[:i] + port[j:], para


def _listed_diff(rel):
    import difflib
    src, port, para = _copy_and_note(rel)
    assert para.startswith(f"Copy of vorbis_tpu/{rel}, kept line-aligned "
                           "with it"), para
    return [ln for ln in difflib.ndiff(src.splitlines(), port.splitlines())
            if ln[:2] in ("- ", "+ ")]


def test_envelope_constants_line_aligned_copy():
    """ops/envelope.py is its whole source, line for line (the scalar
    detector of the golden encoder with the constants the batched one
    reads), but for COPY_LINES, with the same values."""
    assert _listed_diff("ops/envelope.py") == COPY_LINES["ops/envelope.py"]
    names = [k for k in vars(J_env) if k.isupper()]
    assert len(names) >= 10 and "VE_PRE" in names
    for k in names:
        assert _same(getattr(T_env, k), getattr(J_env, k)), k


@pytest.mark.parametrize("rel", sorted(set(COPY_LINES)
                                       - {"ops/envelope.py"}))
def test_golden_encoder_line_aligned_copies(rel):
    """The golden encoder's host modules are their sources, line for
    line, but for COPY_LINES and one paragraph added to the module
    docstring; every function and class of the source is there."""
    assert _listed_diff(rel) == COPY_LINES[rel]
    assert _py_defs(os.path.join(ROOT, "vorbis_tpu_torch", *rel.split(
        "/"))).keys() == _py_defs(os.path.join(ROOT, "vorbis_tpu",
                                               *rel.split("/"))).keys()


def test_scales_numpy_branches_equal_source():
    """utils/scales.py's todB_np and unitnorm_np are the source's numpy
    branches: equal bit for bit on float32 arrays and scalars (signed
    zeros, subnormals, infinities, NaN), and both raise on a float64
    scalar, as the source's todB does."""
    import vorbis_tpu.utils.scales as JS
    import vorbis_tpu_torch.utils.scales as TS
    rng = np.random.RandomState(6)
    x = np.concatenate([rng.randn(4096).astype(np.float32) * 1e3,
                        np.array([0.0, -0.0, 1e-42, -1e-42, np.inf, -np.inf,
                                  np.nan], np.float32)])
    for a in (x, x[5], np.float32(-0.0)):
        assert _same(TS.todB_np(a), JS.todB(a))
        assert _same(TS.unitnorm_np(a), JS.unitnorm(a))
    for f in (TS.todB_np, JS.todB):
        with pytest.raises(ValueError):
            f(np.float64(0.5))


def test_reservoir_chooser_line_aligned_copy():
    """ops/managed.py holds ReservoirChooser (the floater of
    lib/bitrate.c:73-227) line for line as its source does: the text
    from the class line to its last return is the same in both."""
    head = "class ReservoirChooser:"
    tail = "        return choice, truncate, pad"
    blocks = []
    for pkg in ("vorbis_tpu", "vorbis_tpu_torch"):
        lines = open(os.path.join(ROOT, pkg, "ops", "managed.py")).read() \
            .splitlines()
        i = lines.index(head)
        blocks.append(lines[i:lines.index(tail, i) + 1])
    assert blocks[0] == blocks[1]
    assert len(blocks[0]) > 100


def test_rescue_walk_host_c_equals_vorbisnative():
    """vtt_rescue_walk (the port's csrc/host_ogg.c) against vn_rescue_walk
    through vorbis_tpu.native, or against the lockstep Python walk where
    that library is absent, on the same random tables: stretch resets,
    triggers at both window edges, retrig clusters, empty windows."""
    from vorbis_tpu_torch import native
    from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
    rng = np.random.RandomState(11)
    for C, Lw, dens in ((1, 1, 0.5), (7, 64, 0.05), (50, 700, 0.02),
                        (30, 200, 0.3)):
        T1 = rng.rand(13, C, Lw) < dens
        T2 = rng.rand(13, C, Lw) < dens
        wlen = rng.randint(0, Lw + 1, C)
        got = native.rescue_walk(T1, T2, wlen, 24)
        want = J_native.rescue_walk(T1, T2, wlen, 24)
        if want is None:
            want = TFE._rescue_walk_plain(T1, T2, wlen, 24)
        assert all(_same(g, w) for g, w in zip(got, want)), (C, Lw)
    assert got[0].any() and got[1].any()


def test_ogg_crc_host_c_equals_python_loop():
    rng = np.random.RandomState(3)
    for size in (0, 1, 27, 255, 4300, 65307):
        page = rng.bytes(size)
        want = T_ogg.ogg_crc_plain(page)
        assert T_ogg.ogg_crc(page) == want == J_ogg.ogg_crc(page)
        assert T_ogg.ogg_crc(page, 0x1234ABCD) == T_ogg.ogg_crc_plain(
            page, 0x1234ABCD)


def test_ogg_writer_pages_byte_equal():
    rng = np.random.RandomState(4)
    jw, tw = J_ogg.OggStreamWriter(99), T_ogg.OggStreamWriter(99)
    for k in range(300):
        pkt = rng.bytes(int(rng.choice([0, 1, 254, 255, 256, 510, 4000])))
        for w in (jw, tw):
            w.packetin(pkt, 1000 * k, eos=k == 299)
            if k % 7 == 0:
                w.flush()
    jw.flush()
    tw.flush()
    out = tw.pageout_all()
    assert out == jw.pageout_all() and len(out) > 100_000
    got = [p for p, _, _ in T_ogg.OggStreamReader(out).packets()]
    assert got == [p for p, _, _ in J_ogg.OggStreamReader(out).packets()]


def test_decode_ogg_of_port_stream_bitwise():
    pcm = oracle.make_test_signal(seconds=0.5)
    fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False,
                     device="cpu")
    ogg = fe.encode(pcm)
    got, tvi = T_dec.decode_ogg(ogg)
    want, jvi = J_dec.decode_ogg(ogg)
    assert _same(got, want)
    assert (tvi.channels, tvi.rate) == (jvi.channels, jvi.rate)
    assert got.shape == OggVorbisFile(ogg).read_all_float().shape \
        == pcm.shape


def _py_defs(path):
    """{qualified name: source text} of every function and class of a
    module, methods as Class.method."""
    import ast
    text = open(path).read()
    out = {}

    def walk(node, prefix):
        for d in node.body:
            if isinstance(d, (ast.FunctionDef, ast.ClassDef)):
                start = min([d.lineno] + [x.lineno for x in d.decorator_list])
                out[prefix + d.name] = "\n".join(
                    text.splitlines()[start - 1:d.end_lineno])
                if isinstance(d, ast.ClassDef):
                    walk(d, prefix + d.name + ".")

    walk(ast.parse(text), "")
    return out


def _changed_lines(a, b):
    import difflib
    return [ln[2:] for ln in difflib.ndiff(a.splitlines(), b.splitlines())
            if ln[:2] in ("- ", "+ ")]


def test_floor0_codec_line_aligned_copy():
    """codec/floor0_codec.py is its source with one paragraph added to
    the module docstring."""
    src, port = (open(os.path.join(ROOT, pkg, "codec", "floor0_codec.py"))
                 .read() for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    para = re.search(r'56-57\)\.(\n\nCopy of vorbis_tpu/codec/'
                     r'floor0_codec\.py.*?)"""', port, re.S).group(1)
    assert port == src.replace('56-57)."""', f'56-57).{para}"""', 1)
    assert _py_defs(os.path.join(ROOT, "vorbis_tpu_torch", "codec",
                                 "floor0_codec.py")).keys() \
        == _py_defs(os.path.join(ROOT, "vorbis_tpu", "codec",
                                 "floor0_codec.py")).keys()


def test_nativeparse_and_fastdec_copies():
    """codec/nativeparse.py holds every function of its source, the same
    text but for the lines that bind the library; models/fastdec.py
    holds the copied functions of its source verbatim."""
    bind = re.compile(r"_load|decode_library|_sig|restype|argtypes|"
                      r"native library unavailable|fn = L\.vn_parse")
    j, t = (_py_defs(os.path.join(ROOT, pkg, "codec", "nativeparse.py"))
            for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    assert j.keys() == t.keys() and len(j) >= 9
    for k in j:
        bad = [ln for ln in _changed_lines(j[k], t[k])
               if not bind.search(ln) and ln.strip()]
        assert not bad, (k, bad)
    assert _changed_lines(j["StreamParseTables._build"],
                          t["StreamParseTables._build"]) == []
    j, t = (_py_defs(os.path.join(ROOT, pkg, "models", "fastdec.py"))
            for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    for k in ("_win_table", "FastDecodeUnsupported", "FastDecoder.__init__",
              "FastDecoder._trim_range", "FastDecoder.decode_arrays",
              "_decoder_for"):
        if k == "FastDecoder.__init__":
            assert t[k] == j[k].rstrip(), k
        else:
            assert t[k] == j[k], k
    assert "_render_curves" not in t


# The lines by which the port's copies differ from their sources, a
# definition at a time ("-" the source's, "+" the port's): the device
# argument and what it selects, and nothing else.
DEVICE_LINES = {
    "models/fastdec.py": {
        "FastStreamDecoder.__init__": [
            '-     def __init__(self, dec: FastDecoder, hs: int = 0):',
            '+     def __init__(self, dec: FastDecoder, hs: int = 0, '
            'device="cuda"):',
            '+         self.device = _device(device)',
            '+         self._tail = None             # device: the lap '
            'tail, on it',
            '+         self._pinned = {}             # device: staging '
            'buffers, by name'],
        "FastStreamDecoder._process": [
            '-         out = np.zeros((ch, outlen), np.float32)',
            '+         out = (np.zeros((ch, outlen), np.float32) if '
            'self.device is None',
            '+                else None)',
            '+         if self.device is not None:',
            '+             out = self._synth_device(blob, off, sizes * 8, '
            'W, winid,',
            '+                                      starts, centers, '
            'first_ever)',
            '-         if hs:',
            '+         elif hs:'],
        # the port's imdct_batch always returns the blocks (no numpy
        # fall-back), and `imdct` there is the CUDA wrapper
        "FastStreamDecoder._synth_staged": [
            '-             if blocks is None:',
            '-                 blocks = np.asarray(imdct(stack, nh))'],
    },
    "vorbisfile.py": {
        "OggVorbisFile.__init__": [
            '-     def __init__(self, src):',
            '+     def __init__(self, src, device="cuda"):',
            '+         from .models.fastdec import _device',
            '+         self._device = device',
            "+         self._dev = _device(device)   # None: the JAX "
            "package's host path"],
        # a broken build raises instead of reading as "no fast path"
        "OggVorbisFile._make_fast": [
            '-         try:',
            '-             from .models.fastdec import (FastDecodeUnsupported,',
            '+         from .models.fastdec import (FastDecodeUnsupported,',
            '-                                          FastDecoder, '
            'FastStreamDecoder)',
            '+                                      FastDecoder, '
            'FastStreamDecoder)',
            '-         except ImportError:',
            '-             return None',
            '-             return FastStreamDecoder(fd, hs=getattr(self, '
            '"_hs", 0))',
            '+             return FastStreamDecoder(fd, hs=getattr(self, '
            '"_hs", 0),',
            '+                                      device=self._device)'],
        "OggVorbisFile._read_all_batched": [
            '-                 out.append(fd.decode_packets(link_pkts))',
            '+                 out.append(fd.decode_packets(link_pkts, '
            'device=self._dev))'],
        "decode_file": [
            '- def decode_file(src):',
            '+ def decode_file(src, device="cuda"):',
            '-     vf = OggVorbisFile(src)',
            '+     vf = OggVorbisFile(src, device=device)'],
    },
}


def _docstring_head(text):
    import ast
    node = ast.parse(text)
    return ast.get_docstring(node.body[0] if node.body and isinstance(
        node.body[0], ast.ClassDef) else node, clean=False)


@pytest.mark.parametrize("rel", sorted(DEVICE_LINES))
def test_faststream_and_vorbisfile_copies(rel):
    """FastStreamDecoder's methods (models/fastdec.py) and every function
    and method of vorbisfile.py are their sources' text but for the lines
    that carry the device (DEVICE_LINES); the port only adds the staged
    chunk (`_staging`, `_synth_device`), and each docstring it touches
    keeps its source's text in front of the port's paragraph."""
    import difflib
    j, t = (_py_defs(os.path.join(ROOT, pkg, *rel.split("/")))
            for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    scope = [k for k in j if rel == "vorbisfile.py"
             or k.startswith("FastStreamDecoder.")]
    assert len(scope) >= (30 if rel == "vorbisfile.py" else 8)
    added = {k for k in t if k not in j and (
        rel == "vorbisfile.py" or k.startswith("FastStreamDecoder."))}
    assert added == (set() if rel == "vorbisfile.py" else
                     {"FastStreamDecoder._staging",
                      "FastStreamDecoder._synth_device"})
    for k in scope:
        if k in ("FastStreamDecoder", "OggVorbisFile"):
            continue                    # the classes: their methods below
        diff = [ln for ln in difflib.ndiff(j[k].splitlines(),
                                           t[k].splitlines())
                if ln[:2] in ("- ", "+ ")]
        assert diff == DEVICE_LINES[rel].get(k, []), k
    src, port = (open(os.path.join(ROOT, pkg, *rel.split("/"))).read()
                 for pkg in ("vorbis_tpu", "vorbis_tpu_torch"))
    if rel == "vorbisfile.py":
        docs = [_docstring_head(x) for x in (src, port)]
    else:
        docs = [_docstring_head(x["FastStreamDecoder"]) for x in (j, t)]
    assert docs[1].startswith(docs[0]) and len(docs[1]) > len(docs[0])


def _c_defs(path):
    """{name: text} of every top-level function and typedef of a C
    source: from its first line at column 0 to its closing brace."""
    lines = open(path).read().splitlines()
    out = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if (ln and not ln[0].isspace() and ln[0] not in "#/{}*"
                and not ln.endswith(";")):
            j = i
            while lines[j] != "}" and not lines[j].startswith("} "):
                j += 1
            block = lines[i:j + 1]
            head = " ".join(block[:3])
            name = (lines[j][2:].rstrip(";") if lines[j].startswith("} ")
                    else re.search(r"(\w+)\s*\(", head).group(1))
            out[name] = "\n".join(block)
            i = j
        i += 1
    return out


def test_host_decode_c_functions_equal_vorbisnative():
    """Every function and typedef of csrc/host_decode.c is the same text
    as the same-named one in native/vorbisnative.c, and the port's file
    holds the whole decode half and nothing of the encoder's."""
    port = _c_defs(os.path.join(ROOT, "vorbis_tpu_torch", "csrc",
                                "host_decode.c"))
    src = _c_defs(os.path.join(ROOT, "native", "vorbisnative.c"))
    for k, text in port.items():
        assert text == src[k], k
    need = {"rd_bits", "vn_ogg_crc", "vn_huff1", "vn_rd_load", "vn_rd_init",
            "vn_rd_bits", "vn_rd_huff", "vn_ilog", "vn_floor0_curve",
            "vn_render_pt", "vn_parse_one", "vn_pctx_init",
            "vn_parse_packets", "vn_bf8", "vn_bf16", "vn_bf32", "vn_imdct1",
            "vn_imtab_init", "vn_imdct_batch", "vn_lap_add", "vn_bf8_l",
            "vn_bf16_l", "vn_bf32_l", "vn_imdct16_rows", "vn_imdct_batch16",
            "vn_scan_W", "vn_decode_stream", "vn_ogg_scan", "vn_book",
            "vn_rd", "vn_pctx", "vn_imtab"}
    assert need <= port.keys(), need - port.keys()
    assert not port.keys() & {"vn_pack_bits", "vn_pack_bits_multi",
                              "vn_ogg_pages", "vn_rescue_walk",
                              "vn_schedule", "vn_read_fields",
                              "vn_huff_decode"}


def test_ogg_crc_has_no_python_fallback(monkeypatch):
    """A missing host compiler raises; the CRC never falls back to the
    Python loop."""
    from vorbis_tpu_torch import native
    native.host_library.cache_clear()
    monkeypatch.setenv("CC", "")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "BUILD_DIR",
                        native.BUILD_DIR.parent / "no-such-build")
    try:
        with pytest.raises(RuntimeError, match="host C compiler"):
            T_ogg.ogg_crc(b"OggS")
    finally:
        native.host_library.cache_clear()


def test_rescue_walk_has_no_python_fallback(monkeypatch):
    """A missing host compiler raises; the stretch-rescue walk never falls
    back to its plain lockstep version."""
    from vorbis_tpu_torch import native
    native.host_library.cache_clear()
    monkeypatch.setenv("CC", "")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "BUILD_DIR",
                        native.BUILD_DIR.parent / "no-such-build")
    T = np.zeros((13, 2, 8), bool)
    try:
        with pytest.raises(RuntimeError, match="host C compiler"):
            native.rescue_walk(T, T, np.array([8, 3]), 24)
    finally:
        native.host_library.cache_clear()


def _docstring_plus(src, port, end):
    """port is src with one paragraph added before the module docstring's
    closing quotes, which follow `end`; returns the paragraph."""
    para = re.search(re.escape(end) + r'(\n\n.*?)\n"""', port, re.S).group(1)
    assert port == src.replace(end + '\n"""', end + para + '\n"""', 1)
    return para


def test_vq_host_modules_line_aligned_copies():
    """vq/huffbuild.py and vq/latticebuild.py are their sources byte for
    byte; vq/training.py and vq/__init__.py add one paragraph to the
    module docstring, and nothing else."""
    def text(pkg, name):
        return open(os.path.join(ROOT, pkg, "vq", name)).read()

    for name in ("huffbuild.py", "latticebuild.py"):
        assert text("vorbis_tpu_torch", name) == text("vorbis_tpu", name)
    para = _docstring_plus(text("vorbis_tpu", "training.py"),
                           text("vorbis_tpu_torch", "training.py"),
                           "equivalents.")
    assert "Copy of vorbis_tpu/vq/training.py" in para
    para = _docstring_plus(text("vorbis_tpu", "__init__.py"),
                           text("vorbis_tpu_torch", "__init__.py"),
                           "distance computations.")
    assert "Counterpart of vorbis_tpu/vq" in para


# The lines by which the port's lbg_train differs from its source: the
# step's device (the card by default) in place of use_jax.
LBG_DEVICE_LINES = [
    '              seed: int = 0, use_jax: bool = True,',
    '              seed: int = 0, use_torch: bool = True, device=None,',
    '    assignments (N,) int64, mse history list)."""',
    '    assignments (N,) int64, mse history list).  use_torch: the step on',
    '    `device` (default "cuda": with no card that raises, and the CPU',
    '    takes device="cpu"); False: the numpy step."""',
    '    run = _make_step(use_jax)',
    '    if use_torch and device is None:',
    '        if not torch.cuda.is_available():',
    '            raise RuntimeError(',
    '                "lbg_train runs on the card by default and no CUDA "',
    '                "device is available: pass device=\\"cpu\\" (or "',
    '                "use_torch=False) to train on the CPU")',
    '        device = "cuda"',
    '    run = _make_step(device if use_torch else None)']


def test_lbg_host_loop_and_copied_functions():
    """lbg_train's host loop is its source's line for line but for the
    device lines; _pairwise_sq, TorchCodecPipeline.frame and the codec's
    local_book_besterror (with _enc_book_fields) are their sources'
    text."""
    def defs(pkg, *rel):
        return _py_defs(os.path.join(ROOT, pkg, *rel))

    j, t = (defs(p, "vq", "vqgen.py") for p in ("vorbis_tpu",
                                                "vorbis_tpu_torch"))
    assert _changed_lines(j["lbg_train"], t["lbg_train"]) \
        == LBG_DEVICE_LINES
    assert t["_pairwise_sq"] == j["_pairwise_sq"]
    j, t = (defs(p, "models", "pipeline.py") for p in ("vorbis_tpu",
                                                       "vorbis_tpu_torch"))
    assert t["TorchCodecPipeline.frame"] == j["TpuCodecPipeline.frame"]
    j, t = (defs(p, "codec", "residue_codec.py")
            for p in ("vorbis_tpu", "vorbis_tpu_torch"))
    for k in ("local_book_besterror", "_enc_book_fields"):
        assert t[k] == j[k], k
