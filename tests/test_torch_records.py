"""The port's record readers, record iterators and dataset fetchers against
the JAX package's on the CPU.

Every reader and iterator of ``datasets/records.py`` reads the same files
(CSV, lines, directories and globs of them, per-file sequences, an image
tree written with PIL) or collections in both packages: the records, the
batches' features, labels and masks, and the ``RecordMetaData`` they
carry are equal, as are the records reloaded from that metadata and the
errors' messages. The fetchers read IDX files (plain and gzipped), CIFAR
binary batches and ``.npy`` caches the test writes under
``DL4J_TPU_DATA_DIR``, fall back to the same synthetic data, refuse
alike, and give the same Iris (sklearn's copy) and UCI sequences; their
iterators yield the same shuffled batches.
"""

import dataclasses
import gzip
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as r_fetchers
from deeplearning4j_tpu.datasets import normalizers as r_norm
from deeplearning4j_tpu.datasets import records as r_records
from deeplearning4j_tpu_torch.datasets import fetchers as p_fetchers
from deeplearning4j_tpu_torch.datasets import normalizers as p_norm
from deeplearning4j_tpu_torch.datasets import records as p_records

PORT, REF = (p_records, p_norm), (r_records, r_norm)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    out = {}
    rows = [",".join(f"{v:.4f}" for v in rng.normal(size=3)) + f",{i % 4}" for i in range(10)]
    (root / "data.csv").write_text("\n".join(rows) + "\n")
    (root / "header.csv").write_text("a,b,c,label\n" + "\n".join(rows[:5]) + "\n\n")
    (root / "semi.csv").write_text("\n".join(r.replace(",", ";") for r in rows[:4]) + "\n")
    (root / "lines.txt").write_text("one\ntwo words\n\nthree\n")
    parts = root / "parts"
    parts.mkdir()
    for i in range(3):
        (parts / f"p{i}.csv").write_text("\n".join(rows[3 * i:3 * i + 3]) + "\n")
    seqs = root / "seqs"
    seqs.mkdir()
    labs = root / "seq_labels"
    labs.mkdir()
    for i, t in enumerate((4, 6, 3, 5, 6)):
        steps = [",".join(f"{v:.3f}" for v in rng.normal(size=2)) + f",{(i + s) % 3}"
                 for s in range(t)]
        (seqs / f"s{i}.csv").write_text("\n".join(steps) + "\n")
        lt = t if i != 2 else t + 2  # one label sequence longer than its features
        (labs / f"s{i}.csv").write_text("\n".join(str((i * s) % 3) for s in range(lt)) + "\n")
    images = root / "images"
    from PIL import Image
    for label, color in (("cats", (200, 30, 30)), ("dogs", (20, 180, 60))):
        d = images / label / "nested"
        d.mkdir(parents=True)
        for j in range(2):
            arr = (rng.integers(0, 256, size=(9 + j, 7, 3)) // 2 + np.array(color) // 2)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"img{j}.png")
    (images / "cats" / "notes.txt").write_text("not an image")
    flat = root / "flat_images"
    flat.mkdir()
    Image.fromarray(rng.integers(0, 256, size=(5, 5), dtype=np.uint8)).save(flat / "a.png")
    out.update(root=str(root), csv=str(root / "data.csv"), header=str(root / "header.csv"),
               semi=str(root / "semi.csv"), lines=str(root / "lines.txt"), parts=str(parts),
               glob=str(root / "parts" / "p*.csv"), seqs=str(seqs), labs=str(labs),
               images=str(images), flat=str(flat))
    return out


COLLECTION = [[0.5, 1.0, 2], [1.5, -1.0, 0], [2.5, 0.0, 1], [3.5, 1.0, 2], [4.5, 2.0, 0]]
SEQUENCES = [[[0.1, 0.2, 1], [0.3, 0.4, 2]], [[0.5, 0.6, 0]],
             [[0.7, 0.8, 1], [0.9, 1.0, 0], [1.1, 1.2, 2]]]


def plain(value):
    """Readers' outputs as comparable Python values: arrays by dtype, shape
    and bytes, DataSets by their arrays, metadata by its fields."""
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, value.tobytes())
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, dataclasses.astuple(value))
    if hasattr(value, "features") and hasattr(value, "labels"):
        if isinstance(value.features, list):  # MultiDataSet
            return ("multi", plain(value.features), plain(value.labels))
        return ("dataset", plain(np.asarray(value.features)), plain(np.asarray(value.labels)),
                plain(value.features_mask), plain(value.labels_mask),
                plain(getattr(value, "example_meta_data", None)))
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def records_with_meta(reader):
    reader.reset()
    got = []
    while reader.has_next():
        got.append(reader.next_record_with_meta())
    return got, reader.load_from_meta_data([m for _, m in got[::2]])


def sequences_with_meta(reader):
    reader.reset()
    got = []
    while reader.has_next():
        got.append(reader.next_sequence_with_meta())
    return got, reader.load_sequence_from_meta_data(got[-1][1])


CASES = {
    "csv": lambda R, N, f: list(R.CSVRecordReader(f["csv"])),
    "csv_skip_header": lambda R, N, f: list(R.CSVRecordReader(f["header"], skip_lines=1)),
    "csv_delimiter": lambda R, N, f: list(R.CSVRecordReader(f["semi"], delimiter=";")),
    "csv_directory": lambda R, N, f: list(R.CSVRecordReader(f["parts"])),
    "csv_glob": lambda R, N, f: list(R.CSVRecordReader(f["glob"])),
    "csv_list": lambda R, N, f: list(R.CSVRecordReader([f["csv"], f["header"]])),
    "lines": lambda R, N, f: list(R.LineRecordReader(f["lines"])),
    "collection": lambda R, N, f: list(R.CollectionRecordReader(COLLECTION)),
    "csv_meta": lambda R, N, f: records_with_meta(R.CSVRecordReader(f["parts"])),
    "lines_meta": lambda R, N, f: records_with_meta(R.LineRecordReader(f["lines"])),
    "collection_meta": lambda R, N, f: records_with_meta(R.CollectionRecordReader(COLLECTION)),
    "classification": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CSVRecordReader(f["csv"]), 4, label_index=3, num_possible_labels=4)),
    "classification_meta": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CSVRecordReader(f["parts"]), 4, label_index=3, num_possible_labels=4,
        collect_meta_data=True)),
    "label_first": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CollectionRecordReader([[r[2]] + r[:2] for r in COLLECTION]), 2, label_index=0,
        num_possible_labels=3)),
    "regression_range": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CSVRecordReader(f["csv"]), 3, label_index=1, label_index_to=2, regression=True)),
    "regression_one": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CollectionRecordReader(COLLECTION), 5, label_index=0, regression=True)),
    "autoencoder": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CollectionRecordReader([r[:2] for r in COLLECTION]), 2)),
    "max_batches": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.CSVRecordReader(f["csv"]), 3, label_index=3, num_possible_labels=4,
        max_num_batches=2)),
    "reload_from_meta": lambda R, N, f: (lambda it: it.load_from_meta_data(
        list(it)[1].example_meta_data))(R.RecordReaderDataSetIterator(
            R.CSVRecordReader(f["csv"]), 4, label_index=3, num_possible_labels=4,
            collect_meta_data=True)),
    "images": lambda R, N, f: (lambda r: (list(r), r.labels))(
        R.ImageRecordReader(6, 5, 3, f["images"])),
    "images_gray": lambda R, N, f: (lambda r: (list(r), r.labels))(
        R.ImageRecordReader(4, 4, 1, f["flat"])),
    "images_meta": lambda R, N, f: records_with_meta(R.ImageRecordReader(6, 5, 3, f["images"])),
    "image_iterator": lambda R, N, f: (lambda r: list(R.RecordReaderDataSetIterator(
        r, 3, label_index=1, num_possible_labels=len(r.labels), collect_meta_data=True,
        preprocessor=N.ImagePreProcessingScaler())))(R.ImageRecordReader(6, 5, 3, f["images"])),
    "image_autoencoder": lambda R, N, f: list(R.RecordReaderDataSetIterator(
        R.ImageRecordReader(6, 5, 3, f["images"]), 4)),
    "sequences": lambda R, N, f: list(R.CSVSequenceRecordReader(f["seqs"])),
    "sequences_meta": lambda R, N, f: sequences_with_meta(R.CSVSequenceRecordReader(f["seqs"])),
    "collection_sequences_meta": lambda R, N, f: sequences_with_meta(
        R.CollectionSequenceRecordReader(SEQUENCES)),
    "sequence_single": lambda R, N, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CSVSequenceRecordReader(f["seqs"]), 2, num_possible_labels=3, label_index=2,
        collect_meta_data=True)),
    "sequence_single_regression": lambda R, N, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CollectionSequenceRecordReader(SEQUENCES), 3, label_index=0, regression=True)),
    "sequence_two_align_start": lambda R, N, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CSVSequenceRecordReader(f["seqs"]), 3, num_possible_labels=3,
        labels_reader=R.CSVSequenceRecordReader(f["labs"]))),
    "sequence_two_align_end": lambda R, N, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CSVSequenceRecordReader(f["seqs"]), 2, num_possible_labels=3,
        labels_reader=R.CSVSequenceRecordReader(f["labs"]),
        alignment_mode=R.AlignmentMode.ALIGN_END)),
    "sequence_two_regression": lambda R, N, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CSVSequenceRecordReader(f["seqs"]), 5, regression=True,
        labels_reader=R.CSVSequenceRecordReader(f["seqs"]),
        alignment_mode=R.AlignmentMode.EQUAL_LENGTH)),
    "multi": lambda R, N, f: list(R.RecordReaderMultiDataSetIterator.Builder(3)
                                  .add_reader("a", R.CSVRecordReader(f["csv"]))
                                  .add_reader("b", R.CollectionRecordReader(COLLECTION * 2))
                                  .add_input("a", 0, 1).add_input("b", 0, 1)
                                  .add_output("a", 2, 2).add_output_one_hot("b", 2, 3)
                                  .add_input("a").build()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_readers_and_iterators_equal_the_reference(case, files):
    port = plain(CASES[case](*PORT, files))
    ref = plain(CASES[case](*REF, files))
    assert port == ref
    assert port  # every case reads something


ERRORS = {
    "label_out_of_range": lambda R, f: list(R.RecordReaderDataSetIterator(
        R.CollectionRecordReader([[1.0, 7]]), 1, label_index=1, num_possible_labels=3)),
    "negative_label": lambda R, f: list(R.RecordReaderDataSetIterator(
        R.CollectionRecordReader([[1.0, -1]]), 1, label_index=1, num_possible_labels=3)),
    "regression_with_classes": lambda R, f: R.RecordReaderDataSetIterator(
        R.CollectionRecordReader(COLLECTION), 2, label_index=2, num_possible_labels=3,
        regression=True),
    "equal_length_mismatch": lambda R, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CSVSequenceRecordReader(f["seqs"]), 5, num_possible_labels=3,
        labels_reader=R.CSVSequenceRecordReader(f["labs"]),
        alignment_mode=R.AlignmentMode.EQUAL_LENGTH)),
    "labels_reader_shorter": lambda R, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CollectionSequenceRecordReader(SEQUENCES), 2, num_possible_labels=3,
        labels_reader=R.CollectionSequenceRecordReader(SEQUENCES[:1]))),
    "unknown_reader": lambda R, f: R.RecordReaderMultiDataSetIterator.Builder(2)
    .add_reader("a", R.CollectionRecordReader(COLLECTION)).add_input("b").build(),
    "sequence_label_out_of_range": lambda R, f: list(R.SequenceRecordReaderDataSetIterator(
        R.CollectionSequenceRecordReader(SEQUENCES), 2, num_possible_labels=2, label_index=2)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_carry_the_reference_s_messages(case, files):
    with pytest.raises(ValueError) as p:
        ERRORS[case](p_records, files)
    with pytest.raises(ValueError) as r:
        ERRORS[case](r_records, files)
    assert str(p.value) == str(r.value)


def test_readers_without_meta_reload_refuse_alike():
    for R in (p_records, r_records):
        with pytest.raises(NotImplementedError, match="does not support loadFromMetaData"):
            R.RecordReader().load_from_meta_data([R.RecordMetaData(index=0)])
    assert p_records.RecordMetaData(3, "f.csv", "CSVRecordReader").get_location() == \
        r_records.RecordMetaData(3, "f.csv", "CSVRecordReader").get_location() == "f.csv:3"


# ------------------------------------------------------------------ fetchers
def write_idx(path, array, gz=False):
    head = struct.pack(">I", 0x0800 | array.ndim) + b"".join(
        struct.pack(">I", d) for d in array.shape)
    data = head + array.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("fetch")
    rng = np.random.default_rng(1)
    (root / "mnist").mkdir()
    write_idx(root / "mnist" / "train-images-idx3-ubyte", rng.integers(0, 256, (40, 28, 28)))
    write_idx(root / "mnist" / "train-labels-idx1-ubyte", rng.integers(0, 10, 40))
    write_idx(root / "mnist" / "t10k-images.idx3-ubyte.gz", rng.integers(0, 256, (12, 28, 28)),
              gz=True)
    write_idx(root / "mnist" / "t10k-labels.idx1-ubyte.gz", rng.integers(0, 10, 12), gz=True)
    (root / "emnist").mkdir()
    write_idx(root / "emnist" / "emnist-letters-train-images-idx3-ubyte",
              rng.integers(0, 256, (20, 28, 28)))
    write_idx(root / "emnist" / "emnist-letters-train-labels-idx1-ubyte",
              rng.integers(1, 27, 20))
    cifar = root / "cifar-10-batches-bin"
    cifar.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        raw = np.concatenate([rng.integers(0, 10, (3, 1)), rng.integers(0, 256, (3, 3072))],
                             axis=1).astype(np.uint8)
        (cifar / name).write_bytes(raw.tobytes())
    for d, hw, classes in (("svhn", 32, 10), ("tinyimagenet", 64, 200)):
        (root / d).mkdir()
        split = "train"
        np.save(root / d / f"{split}_x.npy", rng.integers(0, 256, (6, hw, hw, 3)))
        np.save(root / d / f"{split}_y.npy", rng.integers(0, classes, 6))
    return str(root)


def batches(it):
    return plain(list(it))


FETCHES = {
    "mnist_train": lambda F: (lambda f: (plain(f.dataset()), plain(f.dataset(normalize=False)),
                                         f.synthetic))(F.MnistDataFetcher(train=True)),
    "mnist_test_gz": lambda F: (lambda f: (plain(f.dataset()), f.synthetic))(
        F.MnistDataFetcher(train=False)),
    "mnist_iterator": lambda F: batches(F.MnistDataSetIterator(16, train=True, seed=4)),
    "emnist_letters": lambda F: batches(F.EmnistDataSetIterator("letters", 8, seed=2)),
    "emnist_synthetic": lambda F: batches(F.EmnistDataSetIterator("digits", 512, train=False)),
    "cifar": lambda F: batches(F.CifarDataSetIterator(4, train=True, seed=3)),
    "cifar_test": lambda F: batches(F.CifarDataSetIterator(4, train=False, shuffle=False)),
    "svhn": lambda F: batches(F.SvhnDataSetIterator(4, train=True)),
    "svhn_synthetic": lambda F: batches(F.SvhnDataSetIterator(128, train=False)),
    "tinyimagenet": lambda F: batches(F.TinyImageNetDataSetIterator(5, train=True)),
    "lfw_synthetic": lambda F: batches(F.LFWDataSetIterator(64, train=False, image_size=16)),
    "iris": lambda F: (lambda it: (batches(it), it.synthetic))(F.IrisDataSetIterator(50)),
    "iris_part": lambda F: batches(F.IrisDataSetIterator(10, num_examples=30, shuffle=True)),
    "uci": lambda F: batches(F.UciSequenceDataSetIterator(100, train=False)),
}


@pytest.mark.parametrize("case", sorted(FETCHES))
def test_fetchers_equal_the_reference(case, data_dir, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", data_dir)
    port, ref = FETCHES[case](p_fetchers), FETCHES[case](r_fetchers)
    assert port == ref and port


def test_synthetic_fallback_and_refusal_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    got = []
    for F in (p_fetchers, r_fetchers):
        f = F.MnistDataFetcher(train=False, synthetic_size=64, seed=9)
        with pytest.raises(FileNotFoundError) as e:
            F.MnistDataFetcher(allow_synthetic=False)
        got.append((f.synthetic, plain(f.dataset()), str(e.value).replace(str(tmp_path), "D"),
                    batches(F.CifarDataSetIterator(512, train=False, shuffle=False))))
    assert got[0] == got[1] and got[0][0] is True
    with pytest.raises(ValueError) as p:
        p_fetchers.EmnistDataSetIterator("nope", 4)
    with pytest.raises(ValueError) as r:
        r_fetchers.EmnistDataSetIterator("nope", 4)
    assert str(p.value) == str(r.value)
