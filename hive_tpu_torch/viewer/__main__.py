"""``python -m hive_tpu_torch.viewer``: serve exported mesh videos."""

from hive_tpu_torch.viewer import main

if __name__ == "__main__":
    main()
