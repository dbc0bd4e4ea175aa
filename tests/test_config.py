import pytest

from mini_parallel.utils import config


def test_chunk_size_mandatory():
    with pytest.raises(config.ConfigError, match="GPU_CHUNK_SIZE_READS not set"):
        config.get_config(env={})


def test_chunk_size_invalid():
    with pytest.raises(config.ConfigError, match="Invalid GPU_CHUNK_SIZE_READS"):
        config.get_config(env={"GPU_CHUNK_SIZE_READS": "ten"})


def test_alias_and_defaults():
    cfg = config.get_config(env={"CHUNK_SIZE_READS": "500"})
    assert cfg.chunk_size_reads == 500
    assert cfg.lanes == 8 and cfg.reads_per_lane == 2
    assert cfg.total_files == 16
    assert cfg.mode == "kadane"


def test_bad_lane_count_falls_back_to_default():
    # Reference: .parse().unwrap_or(8), aligner.rs:190-191
    cfg = config.get_config(env={"GPU_CHUNK_SIZE_READS": "10", "WGS_LANES": "x"})
    assert cfg.lanes == 8


def test_wgs_file_list_naming():
    cfg = config.get_config(
        env={
            "GPU_CHUNK_SIZE_READS": "10000",
            "WGS_DATA_DIR": "/data",
            "WGS_SAMPLE_ID": "SAMPLE_001",
            "WGS_LANES": "2",
            "WGS_READS_PER_LANE": "2",
        }
    )
    files = cfg.wgs_file_list()
    assert files[0] == "/data/SAMPLE_001_L001_R1_001.fastq.gz"
    assert files[-1] == "/data/SAMPLE_001_L002_R2_001.fastq.gz"
    assert len(files) == 4


def test_dotenv_no_override(tmp_path):
    p = tmp_path / ".env"
    p.write_text("# comment\nFOO=bar\nBAZ='qux'\n")
    env = {"FOO": "keep"}
    out = config.load_dotenv(str(p), env=env)
    assert out["FOO"] == "keep" and out["BAZ"] == "qux"


def test_mesh_shape_parse():
    cfg = config.get_config(env={"GPU_CHUNK_SIZE_READS": "1", "MPT_MESH_SHAPE": "4x2"})
    assert cfg.mesh_shape == (4, 2)
