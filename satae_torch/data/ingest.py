"""EuroSAT ingest: directory scan and decode-once uint8 arrays with an .npz
cache. The port's copy of satae/data/ingest.py, with satae's behaviour:

* ImageFolder semantics: classes are the sorted subdirectory names, labels
  their ranks; hidden and archive-metadata entries (``__MACOSX``, dot files)
  are neither classes nor images;
* decode backends, fastest first: the native libjpeg loader
  (satae_torch.io.native_loader, built from csrc/loader.cc) when it builds
  and every file is a JPEG, PIL otherwise;
* ``cfg.root`` may be a class-folder tree or a ``.zip`` of one (extracted
  once, atomically, under ``cache_dir`` or beside the archive); a root that
  is set but unusable raises instead of switching to synthetic data;
* with ``cache_dir`` the decoded arrays, and the synthetic stand-in when
  ``root`` is None, are cached as ``.npz``.

The synthetic cache key hashes the generator's source file, here the port's
own satae_torch/data/synthetic.py, whose bytes differ from satae's copy: the
two packages keep separate cache files for the same configuration, holding
the same arrays.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from satae_torch.config import DataConfig
from satae_torch.data.synthetic import make_synthetic_eurosat

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}

# Archive/OS metadata that must never become a class or an image: macOS
# zips ship a __MACOSX/ tree of "._*" AppleDouble resource forks (with .jpg
# suffixes PIL cannot decode), plus .DS_Store etc.
_JUNK_DIR_NAMES = {"__MACOSX"}


def _is_image_file(p: Path) -> bool:
    return (p.suffix.lower() in _IMG_EXTS
            and not p.name.startswith("."))


def _class_dirs(rootp: Path) -> list:
    return [d for d in rootp.iterdir()
            if d.is_dir() and not d.name.startswith(".")
            and d.name not in _JUNK_DIR_NAMES]


@dataclass
class RawDataset:
    """The decode-once cache: everything downstream is numpy indexing."""

    images: np.ndarray  # uint8 (N, H, W, 3)
    labels: np.ndarray  # int32 (N,)
    classes: Tuple[str, ...]

    def __len__(self) -> int:
        return int(self.images.shape[0])


def _junk_parts(parts: Sequence[str]) -> bool:
    return any(part in _JUNK_DIR_NAMES or part.startswith(".")
               for part in parts)


def scan_folder(root: str) -> Tuple[Sequence[Path], np.ndarray, Tuple[str, ...]]:
    """ImageFolder-style scan: class = sorted subdir name, label = its rank.

    Images inside hidden/metadata subdirectories of a class dir (e.g.
    ``AnnualCrop/.ipynb_checkpoints/``) are excluded — they would otherwise
    silently pollute the labeled set with duplicate/stale copies."""
    rootp = Path(root)
    classes = tuple(sorted(d.name for d in _class_dirs(rootp)))
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        for p in sorted((rootp / cls).rglob("*")):
            if (_is_image_file(p)
                    and not _junk_parts(p.relative_to(rootp / cls).parts[:-1])):
                paths.append(p)
                labels.append(idx)
    return paths, np.asarray(labels, np.int32), classes


def scan_images(root: str) -> Sequence[Path]:
    """All image files under ``root`` (flat dir, class tree, or one file) in
    sorted order — the unlabeled-serving counterpart of scan_folder."""
    rootp = Path(root)
    if rootp.is_file():
        return [rootp]
    return sorted(p for p in rootp.rglob("*")
                  if _is_image_file(p)
                  and not _junk_parts(p.relative_to(rootp).parts[:-1]))


def decode_images(paths: Sequence[Path], image_size: int = 64) -> np.ndarray:
    """Decode arbitrary image paths to a uint8 (N, S, S, 3) array (native
    libjpeg batch decode when eligible, PIL otherwise)."""
    return _decode(list(paths), image_size)


def _decode_pil(paths: Sequence[Path], image_size: int) -> np.ndarray:
    from PIL import Image

    out = np.empty((len(paths), image_size, image_size, 3), np.uint8)
    for i, p in enumerate(paths):
        try:
            with Image.open(p) as im:
                im = im.convert("RGB")
                if im.size != (image_size, image_size):
                    im = im.resize((image_size, image_size))
                out[i] = np.asarray(im, np.uint8)
        except Exception as e:
            # PIL's truncated-file OSError carries no filename; 20k images
            # into a real EuroSAT decode that's undebuggable.
            raise ValueError(f"failed to decode image {p}: {e}") from e
    return out


def _decode(paths: Sequence[Path], image_size: int) -> np.ndarray:
    try:
        from satae_torch.io.native_loader import (decode_batch,
                                                  native_available)

        if native_available() and all(
                p.suffix.lower() in (".jpg", ".jpeg") for p in paths):
            return decode_batch([str(p) for p in paths], image_size)
    except Exception:
        pass
    return _decode_pil(paths, image_size)


def _cache_path(cache_dir: str, root: str, image_size: int,
                paths: Sequence[Path]) -> Path:
    """Cache key hashes the sorted relative file list (not just the root
    path), so renames, additions, or swapped class folders invalidate the
    decode cache instead of silently serving stale arrays. File contents are
    not hashed (that would cost a full read, defeating the cache); replace
    the cache_dir when re-encoding images in place."""
    h = hashlib.sha1(f"{os.path.abspath(root)}:{image_size}".encode())
    rootp = Path(root)
    for p in paths:
        h.update(str(p.relative_to(rootp)).encode())
        h.update(b"\0")
    return Path(cache_dir) / f"eurosat_{h.hexdigest()[:16]}.npz"


def load_folder(root: str, image_size: int = 64,
                cache_dir: Optional[str] = None) -> RawDataset:
    """Scan + decode a class-subfolder image tree, with an .npz decode cache."""
    paths, labels, classes = scan_folder(root)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    cp = _cache_path(cache_dir, root, image_size, paths) if cache_dir else None
    if cp is not None and cp.exists():
        try:
            z = np.load(cp, allow_pickle=False)
            return RawDataset(z["images"], z["labels"],
                              tuple(str(c) for c in z["classes"]))
        except Exception:
            # corrupt (e.g. interrupted write): re-decode; a concurrent
            # process may have unlinked the same torn cache first
            cp.unlink(missing_ok=True)
    images = _decode(paths, image_size)
    ds = RawDataset(images, labels, classes)
    if cp is not None:
        cp.parent.mkdir(parents=True, exist_ok=True)
        _atomic_savez(cp, images=ds.images, labels=ds.labels,
                      classes=np.asarray(ds.classes))
    return ds


def _atomic_savez(cp: Path, **arrays) -> None:
    """np.savez into a PER-PROCESS tmp file, then atomic rename: concurrent
    writers of the same cache never truncate each other's in-flight file
    (a shared tmp name would), and each replace installs a complete .npz —
    last writer wins with identical content."""
    tmp = cp.parent / f"{cp.stem}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, cp)
    finally:
        tmp.unlink(missing_ok=True)


def _zip_extract_dir(zip_path: str, cache_dir: Optional[str]) -> Path:
    """Extraction destination keyed on the archive's identity (path, size,
    mtime) so a replaced EuroSAT.zip re-extracts instead of serving the old
    tree. Lives under cache_dir when set, else next to the archive."""
    st = os.stat(zip_path)
    h = hashlib.sha1(
        f"{os.path.abspath(zip_path)}:{st.st_size}:{st.st_mtime_ns}"
        .encode()).hexdigest()[:16]
    base = Path(cache_dir) if cache_dir else Path(zip_path).parent
    return base / f"{Path(zip_path).stem}_extracted_{h}"


def _find_tree_root(root: Path) -> Path:
    """Descend through single-directory wrappers: the real EuroSAT.zip nests
    the class tree inside one top-level folder (``2750/`` or
    ``EuroSAT_RGB/``), which ImageFolder users strip by hand. Metadata dirs
    (``__MACOSX``, hidden) don't count as wrappers or classes; a sole subdir
    that directly holds images is a CLASS dir (one-class tree), not a
    wrapper, so descent stops a level above it."""
    cur = root
    while True:
        subdirs = _class_dirs(cur)
        has_images = any(_is_image_file(f)
                         for f in cur.iterdir() if f.is_file())
        if has_images or len(subdirs) != 1:
            return cur
        sole = subdirs[0]
        if any(_is_image_file(f) for f in sole.iterdir() if f.is_file()):
            return cur
        cur = sole


_EXTRACT_MARKER = ".satae_extract_complete"


def _evict_stale_extractions(zip_path: str, dest: Path, image_size: int,
                             cache_dir: Optional[str]) -> None:
    """Remove extraction dirs of SUPERSEDED versions of this archive (same
    stem, different identity hash) plus their decode .npz caches — without
    eviction every zip replacement would leak a full dataset copy. Only dirs
    carrying our completion marker are touched."""
    import glob as _glob
    import shutil

    stem = _glob.escape(Path(zip_path).stem)  # stems may contain [], * etc.
    for old in dest.parent.glob(f"{stem}_extracted_*"):
        if old == dest or not (old / _EXTRACT_MARKER).exists():
            continue
        try:
            old_root = _find_tree_root(old)
            paths, _, _ = scan_folder(str(old_root))
            if cache_dir and paths:
                _cache_path(cache_dir, str(old_root), image_size,
                            paths).unlink(missing_ok=True)
        except OSError:
            pass
        shutil.rmtree(old, ignore_errors=True)


def extract_zip_tree(zip_path: str, cache_dir: Optional[str] = None,
                     image_size: int = 64) -> Path:
    """Extract an image archive once and return its inner tree root (any
    single-folder wrapper stripped). The shared machinery behind both
    ``load_zip`` (labeled training data) and the serving CLIs' ``--images``
    (unlabeled zips); ``image_size`` only keys the eviction of superseded
    decode caches.

    Extraction goes into a private temp dir and is atomically renamed into
    place: concurrent processes sharing the default cache dir each extract
    their own copy and exactly one rename wins — nobody ever decodes
    half-written files (the decode cache keys on the file LIST, so a torn
    extraction would otherwise be cached and served forever). A dest without
    the completion marker (a crashed pre-atomic run) is discarded.
    """
    import shutil
    import tempfile
    import zipfile

    dest = _zip_extract_dir(zip_path, cache_dir)
    marker = dest / _EXTRACT_MARKER
    if not marker.exists():
        dest.parent.mkdir(parents=True, exist_ok=True)
        _evict_stale_extractions(zip_path, dest, image_size, cache_dir)
        # re-check the marker: a concurrent extraction may have completed
        # since the gate above, and deleting a WINNER'S tree would yank files
        # out from under its decode; a markerless dest is a crashed run
        # (possibly being removed by another straggler too — ignore_errors)
        if dest.exists() and not marker.exists():
            shutil.rmtree(dest, ignore_errors=True)
        # dot-prefixed so a leaked tmp dir is invisible to the stale-eviction
        # glob and to _class_dirs
        tmp = Path(tempfile.mkdtemp(prefix=f".{dest.name}.tmp.",
                                    dir=dest.parent))
        try:
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(tmp)
            (tmp / _EXTRACT_MARKER).write_text("ok")
            os.rename(tmp, dest)
        except OSError:
            # rename onto an existing dest = a concurrent extraction won;
            # anything else (incl. a failed extract) is real
            if not marker.exists():
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return _find_tree_root(dest)


def load_zip(zip_path: str, image_size: int = 64,
             cache_dir: Optional[str] = None) -> RawDataset:
    """Ingest a class-tree archive (e.g. the EuroSAT.zip distribution)
    without manual unzipping: extract once (``extract_zip_tree``), then
    reuse the normal decode-once folder path. Replaces the hand-unzip step
    before the reference's ImageFolder load (Report.md:22-39)."""
    root = extract_zip_tree(zip_path, cache_dir, image_size)
    return load_folder(str(root), image_size, cache_dir)


def resolve_image_root(path: str, cache_dir: Optional[str] = None,
                       image_size: int = 64) -> str:
    """Serving-input normalizer: a directory or single image passes through;
    a ``.zip`` archive is extracted once and its tree root returned — so
    ``predict``/``reconstruct --images`` accept the unextracted
    EuroSAT.zip exactly like ``--data`` does."""
    if os.path.isfile(path) and path.lower().endswith(".zip"):
        return str(extract_zip_tree(path, cache_dir, image_size))
    return path


def load_dataset(cfg: DataConfig) -> RawDataset:
    """Real EuroSAT (directory tree or .zip archive) when ``cfg.root`` is
    set, else the synthetic stand-in. A root that is set but unusable RAISES
    rather than silently training on synthetic data (a typo'd --data would
    otherwise produce a plausible-looking run on the wrong dataset).

    The synthetic generator is deterministic but slow at full scale
    (float64 temporaries), so when ``cache_dir`` is set the generated arrays
    are cached to .npz exactly like decoded images; the key pins every
    generation parameter and the generator's source, so a change
    regenerates."""
    if cfg.root:
        if os.path.isdir(cfg.root):
            return load_folder(cfg.root, cfg.image_size, cfg.cache_dir)
        if os.path.isfile(cfg.root) and cfg.root.lower().endswith(".zip"):
            return load_zip(cfg.root, cfg.image_size, cfg.cache_dir)
        raise FileNotFoundError(
            f"data root {cfg.root!r} is neither a directory nor a .zip "
            "archive; leave it unset to use the synthetic stand-in")
    cp = None
    if cfg.cache_dir:
        # the key also hashes the GENERATOR SOURCE so editing synthetic.py
        # invalidates the cache (a stale dataset would silently defeat any
        # quality run measuring the generator change)
        import satae_torch.data.synthetic as _synth
        src_hash = hashlib.sha256(
            Path(_synth.__file__).read_bytes()).hexdigest()[:12]
        cp = Path(cfg.cache_dir) / (
            f"synthetic_{cfg.synthetic_difficulty}_{cfg.per_class}"
            f"_{cfg.image_size}_{cfg.subsample_seed}_{src_hash}.npz")
        if cp.exists():
            try:
                blob = np.load(cp)
                return RawDataset(blob["images"], blob["labels"],
                                  tuple(blob["classes"].tolist()))
            except Exception:
                # corrupt (e.g. interrupted write): regenerate; a concurrent
                # process may have unlinked the same torn cache first
                cp.unlink(missing_ok=True)
    images, labels, classes = make_synthetic_eurosat(
        per_class=cfg.per_class, image_size=cfg.image_size,
        seed=cfg.subsample_seed, difficulty=cfg.synthetic_difficulty)
    if cp is not None:
        cp.parent.mkdir(parents=True, exist_ok=True)
        _atomic_savez(cp, images=images, labels=labels,
                      classes=np.array(classes))
    return RawDataset(images, labels, classes)
