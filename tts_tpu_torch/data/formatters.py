"""Dataset formatters (port of ``tts_tpu/data/formatters.py``, copied
unchanged; reference ``TTS/tts/datasets/formatters.py``): each parses a
corpus's metadata into sample dicts ``{text, audio_file, speaker_name,
root_path, ...}``, pandas-free (stdlib ``csv``). Plain Python, no torch.
"""

from __future__ import annotations

import csv
import os
import re
import xml.etree.ElementTree as ET
from glob import glob
from pathlib import Path
from typing import List, Optional


def _read_pipe_table(filepath: str):
    """Read a '|'-separated table with a header row into dicts."""
    with open(filepath, "r", encoding="utf8") as f:
        reader = csv.DictReader(f, delimiter="|")
        return list(reader)


def _ignored(speaker, ignored_speakers) -> bool:
    return isinstance(ignored_speakers, list) and speaker in ignored_speakers


def cml_tts(root_path, meta_file, ignored_speakers=None):
    """CML-TTS (reference ``formatters.py:16``)."""
    rows = _read_pipe_table(os.path.join(root_path, meta_file))
    items = []
    not_found = 0
    for row in rows:
        speaker = row.get("client_id", "default")
        if _ignored(speaker, ignored_speakers):
            continue
        audio_path = os.path.join(root_path, row["wav_filename"])
        if not os.path.exists(audio_path):
            not_found += 1
            continue
        items.append(
            {
                "text": row["transcript"],
                "audio_file": audio_path,
                "speaker_name": speaker,
                "emotion_name": row.get("emotion_name", "neutral"),
                "root_path": root_path,
            }
        )
    if not_found:
        print(f" | > [!] {not_found} files not found")
    return items


def coqui(root_path, meta_file, ignored_speakers=None):
    """Coqui internal format (reference ``formatters.py:55``)."""
    rows = _read_pipe_table(os.path.join(root_path, meta_file))
    items = []
    not_found = 0
    for row in rows:
        speaker = row.get("speaker_name", "coqui")
        if _ignored(speaker, ignored_speakers):
            continue
        audio_path = os.path.join(root_path, row["audio_file"])
        if not os.path.exists(audio_path):
            not_found += 1
            continue
        items.append(
            {
                "text": row["text"],
                "audio_file": audio_path,
                "speaker_name": speaker,
                "emotion_name": row.get("emotion_name", "neutral"),
                "root_path": root_path,
            }
        )
    if not_found:
        print(f" | > [!] {not_found} files not found")
    return items


def tweb(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("\t")
            items.append(
                {
                    "text": cols[1],
                    "audio_file": os.path.join(root_path, cols[0] + ".wav"),
                    "speaker_name": "tweb",
                    "root_path": root_path,
                }
            )
    return items


def mozilla(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[0].strip(),
                    "audio_file": os.path.join(root_path, "wavs", cols[1].strip()),
                    "speaker_name": "mozilla",
                    "root_path": root_path,
                }
            )
    return items


def mozilla_de(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="ISO 8859-1") as f:
        for line in f:
            cols = line.strip().split("|")
            wav = cols[0].strip()
            folder = f"BATCH_{wav.split('_')[0]}_FINAL"
            items.append(
                {
                    "text": cols[1].strip(),
                    "audio_file": os.path.join(root_path, folder, wav),
                    "speaker_name": "mozilla",
                    "root_path": root_path,
                }
            )
    return items


def mailabs(root_path, meta_files=None, ignored_speakers=None):
    """M-AI-Labs: speaker from the by_book folder structure
    (reference ``formatters.py:140``)."""
    speaker_regex = re.compile(
        f"by_book{re.escape(os.sep)}(male|female){re.escape(os.sep)}(?P<speaker_name>[^{re.escape(os.sep)}]+){re.escape(os.sep)}"
    )
    csv_files = meta_files or glob(root_path + f"{os.sep}**{os.sep}metadata.csv", recursive=True)
    items = []
    for csv_file in csv_files:
        txt_file = csv_file if os.path.isfile(csv_file) else os.path.join(root_path, csv_file)
        folder = os.path.dirname(txt_file)
        m = speaker_regex.search(txt_file)
        if m is None:
            continue
        speaker = m.group("speaker_name")
        if _ignored(speaker, ignored_speakers):
            continue
        with open(txt_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.split("|")
                if not meta_files:
                    wav_file = os.path.join(folder, "wavs", cols[0] + ".wav")
                else:
                    wav_file = os.path.join(
                        root_path, folder.replace("metadata.csv", ""), "wavs", cols[0] + ".wav"
                    )
                if os.path.isfile(wav_file):
                    items.append(
                        {
                            "text": cols[1].strip(),
                            "audio_file": wav_file,
                            "speaker_name": speaker,
                            "root_path": root_path,
                        }
                    )
                else:
                    print(f"> File {wav_file} does not exist!")
    return items


def ljspeech(root_path, meta_file, **kwargs):
    """LJSpeech (reference ``formatters.py:191``)."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[2],
                    "audio_file": os.path.join(root_path, "wavs", cols[0] + ".wav"),
                    "speaker_name": "ljspeech",
                    "root_path": root_path,
                }
            )
    return items


def ljspeech_test(root_path, meta_file, **kwargs):
    """LJSpeech with synthetic 2-sample speakers for eval-split testing."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        speaker_id = 0
        for idx, line in enumerate(f):
            if idx % 2 == 0:
                speaker_id += 1
            cols = line.split("|")
            items.append(
                {
                    "text": cols[2],
                    "audio_file": os.path.join(root_path, "wavs", cols[0] + ".wav"),
                    "speaker_name": f"ljspeech-{speaker_id}",
                    "root_path": root_path,
                }
            )
    return items


def thorsten(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[1],
                    "audio_file": os.path.join(root_path, "wavs", cols[0] + ".wav"),
                    "speaker_name": "thorsten",
                    "root_path": root_path,
                }
            )
    return items


def sam_accenture(root_path, meta_file, **kwargs):
    xml_root = ET.parse(os.path.join(root_path, "voice_over_recordings", meta_file)).getroot()
    items = []
    for item in xml_root.findall("./fileid"):
        wav_file = os.path.join(root_path, "vo_voice_quality_transformation", item.get("id") + ".wav")
        if not os.path.exists(wav_file):
            print(f" [!] {wav_file} in metafile does not exist. Skipping...")
            continue
        items.append(
            {
                "text": item.text,
                "audio_file": wav_file,
                "speaker_name": "sam_accenture",
                "root_path": root_path,
            }
        )
    return items


def ruslan(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[1],
                    "audio_file": os.path.join(root_path, "RUSLAN", cols[0] + ".wav"),
                    "speaker_name": "ruslan",
                    "root_path": root_path,
                }
            )
    return items


def css10(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[1],
                    "audio_file": os.path.join(root_path, cols[0]),
                    "speaker_name": "css10",
                    "root_path": root_path,
                }
            )
    return items


def nancy(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            utt_id = line.split()[1]
            text = line[line.find('"') + 1 : line.rfind('"') - 1]
            items.append(
                {
                    "text": text,
                    "audio_file": os.path.join(root_path, "wavn", utt_id + ".wav"),
                    "speaker_name": "nancy",
                    "root_path": root_path,
                }
            )
    return items


def common_voice(root_path, meta_file, ignored_speakers=None):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("client_id"):
                continue
            cols = line.split("\t")
            speaker = cols[0]
            if _ignored(speaker, ignored_speakers):
                continue
            items.append(
                {
                    "text": cols[2],
                    "audio_file": os.path.join(root_path, "clips", cols[1].replace(".mp3", ".wav")),
                    "speaker_name": "MCV_" + speaker,
                    "root_path": root_path,
                }
            )
    return items


def libri_tts(root_path, meta_files=None, ignored_speakers=None):
    items = []
    if not meta_files:
        meta_files = glob(f"{root_path}/**/*trans.tsv", recursive=True)
    elif isinstance(meta_files, str):
        meta_files = [os.path.join(root_path, meta_files)]
    for meta_file in meta_files:
        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.split("\t")
                file_name = cols[0]
                speaker_name, chapter_id, *_ = cols[0].split("_")
                if _ignored(speaker_name, ignored_speakers):
                    continue
                wav_file = os.path.join(root_path, speaker_name, chapter_id, file_name + ".wav")
                items.append(
                    {
                        "text": cols[2],
                        "audio_file": wav_file,
                        "speaker_name": f"LTTS_{speaker_name}",
                        "root_path": root_path,
                    }
                )
    for item in items:
        assert os.path.exists(item["audio_file"]), f" [!] wav files don't exist - {item['audio_file']}"
    return items


def custom_turkish(root_path, meta_file, **kwargs):
    items, skipped = [], []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            wav_file = os.path.join(root_path, "wavs", cols[0].strip() + ".wav")
            if not os.path.exists(wav_file):
                skipped.append(wav_file)
                continue
            items.append(
                {
                    "text": cols[1].strip(),
                    "audio_file": wav_file,
                    "speaker_name": "turkish-female",
                    "root_path": root_path,
                }
            )
    print(f" [!] {len(skipped)} files skipped. They don't exist...")
    return items


def brspeech(root_path, meta_file, ignored_speakers=None):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("wav_filename"):
                continue
            cols = line.split("|")
            if _ignored(cols[3], ignored_speakers):
                continue
            items.append(
                {
                    "text": cols[2],
                    "audio_file": os.path.join(root_path, cols[0]),
                    "speaker_name": cols[3],
                    "root_path": root_path,
                }
            )
    return items


def vctk(root_path, meta_files=None, wavs_path="wav48_silence_trimmed", mic="mic1", ignored_speakers=None):
    """VCTK v0.92 (reference ``formatters.py:398``)."""
    file_ext = "flac"
    items = []
    meta_files = glob(f"{os.path.join(root_path, 'txt')}/**/*.txt", recursive=True)
    for meta_file in meta_files:
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if _ignored(speaker_id, ignored_speakers):
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readlines()[0]
        use_mic = "mic1" if speaker_id == "p280" else mic  # p280 has no mic2
        wav_file = os.path.join(root_path, wavs_path, speaker_id, f"{file_id}_{use_mic}.{file_ext}")
        if os.path.exists(wav_file):
            items.append(
                {
                    "text": text,
                    "audio_file": wav_file,
                    "speaker_name": "VCTK_" + speaker_id,
                    "root_path": root_path,
                }
            )
        else:
            print(f" [!] wav files don't exist - {wav_file}")
    return items


def vctk_old(root_path, meta_files=None, wavs_path="wav48", ignored_speakers=None):
    items = []
    meta_files = glob(f"{os.path.join(root_path, 'txt')}/**/*.txt", recursive=True)
    for meta_file in meta_files:
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if _ignored(speaker_id, ignored_speakers):
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readlines()[0]
        items.append(
            {
                "text": text,
                "audio_file": os.path.join(root_path, wavs_path, speaker_id, file_id + ".wav"),
                "speaker_name": "VCTK_old_" + speaker_id,
                "root_path": root_path,
            }
        )
    return items


def synpaflex(root_path, metafiles=None, **kwargs):
    items = []
    root_path = os.path.join(root_path, "")
    for wav_file in glob(f"{root_path}**/*.wav", recursive=True):
        if os.sep + "wav" + os.sep in wav_file:
            txt_file = wav_file.replace("wav", "txt")
        else:
            txt_file = os.path.join(
                os.path.dirname(wav_file), "txt", os.path.basename(wav_file).replace(".wav", ".txt")
            )
        if os.path.exists(txt_file) and os.path.exists(wav_file):
            with open(txt_file, "r", encoding="utf-8") as f:
                text = f.readlines()[0]
            items.append(
                {
                    "text": text,
                    "audio_file": wav_file,
                    "speaker_name": "synpaflex",
                    "root_path": root_path,
                }
            )
    return items


def open_bible(root_path, meta_files="train", ignore_digits_sentences=True, ignored_speakers=None):
    items = []
    split_dir = meta_files
    for meta_file in glob(f"{os.path.join(root_path, split_dir)}/**/*.txt", recursive=True):
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if _ignored(speaker_id, ignored_speakers):
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readline().replace("\n", "")
        if ignore_digits_sentences and any(map(str.isdigit, text)):
            continue
        items.append(
            {
                "text": text,
                "audio_file": os.path.join(root_path, split_dir, speaker_id, file_id + ".flac"),
                "speaker_name": "OB_" + speaker_id,
                "root_path": root_path,
            }
        )
    return items


def mls(root_path, meta_files=None, ignored_speakers=None):
    items = []
    with open(os.path.join(root_path, meta_files), "r", encoding="utf-8") as meta:
        for line in meta:
            file, text = line.split("\t")
            text = text[:-1]
            speaker, book, *_ = file.split("_")
            if _ignored(speaker, ignored_speakers):
                continue
            items.append(
                {
                    "text": text,
                    "audio_file": os.path.join(
                        root_path, os.path.dirname(meta_files), "audio", speaker, book, file + ".wav"
                    ),
                    "speaker_name": "MLS_" + speaker,
                    "root_path": root_path,
                }
            )
    return items


def voxceleb2(root_path, meta_file=None, **kwargs):
    return _voxcel_x(root_path, meta_file, voxcel_idx="2")


def voxceleb1(root_path, meta_file=None, **kwargs):
    return _voxcel_x(root_path, meta_file, voxcel_idx="1")


def _voxcel_x(root_path, meta_file, voxcel_idx):
    """Crawl VoxCeleb wavs, caching a metafile (reference ``formatters.py:540``)."""
    assert voxcel_idx in ["1", "2"]
    expected_count = 148_000 if voxcel_idx == "1" else 1_000_000
    voxceleb_path = Path(root_path)
    cache_to = voxceleb_path / f"metafile_voxceleb{voxcel_idx}.csv"
    cache_to.parent.mkdir(exist_ok=True)
    if meta_file is not None:
        with open(str(meta_file), "r", encoding="utf-8") as f:
            return [x.strip().split("|") for x in f.readlines()]
    if not cache_to.exists():
        cnt = 0
        meta_data = []
        for path in voxceleb_path.rglob("**/*.wav"):
            speaker_id = str(Path(path).parent.parent.stem)
            assert speaker_id.startswith("id")
            meta_data.append(f"None|{path}|voxcel{voxcel_idx}_{speaker_id}\n")
            cnt += 1
        with open(str(cache_to), "w", encoding="utf-8") as f:
            f.write("".join(meta_data))
        if cnt < expected_count:
            raise ValueError(
                f"Found too few instances for Voxceleb. Should be around {expected_count}, is: {cnt}"
            )
    with open(str(cache_to), "r", encoding="utf-8") as f:
        return [x.strip().split("|") for x in f.readlines()]


def emotion(root_path, meta_file, ignored_speakers=None):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("file_path"):
                continue
            cols = line.split(",")
            if _ignored(cols[1], ignored_speakers):
                continue
            items.append(
                {
                    "audio_file": os.path.join(root_path, cols[0]),
                    "speaker_name": cols[1],
                    "emotion_name": cols[2].replace("\n", ""),
                    "root_path": root_path,
                }
            )
    return items


def baker(root_path: str, meta_file: str, **kwargs) -> List[dict]:
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            wav_name, text = line.rstrip("\n").split("|")
            items.append(
                {
                    "text": text,
                    "audio_file": os.path.join(root_path, "clips_22", wav_name),
                    "speaker_name": "baker",
                    "root_path": root_path,
                }
            )
    return items


def kokoro(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[2].replace(" ", ""),
                    "audio_file": os.path.join(root_path, "wavs", cols[0] + ".wav"),
                    "speaker_name": "kokoro",
                    "root_path": root_path,
                }
            )
    return items


def kss(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[2],
                    "audio_file": os.path.join(root_path, cols[0]),
                    "speaker_name": "kss",
                    "root_path": root_path,
                }
            )
    return items


def bel_tts_formatter(root_path, meta_file, **kwargs):
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.split("|")
            items.append(
                {
                    "text": cols[1],
                    "audio_file": os.path.join(root_path, cols[0]),
                    "speaker_name": "bel_tts",
                    "root_path": root_path,
                }
            )
    return items
