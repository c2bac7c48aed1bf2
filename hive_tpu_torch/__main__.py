"""`python -m hive_tpu_torch` — run the pipeline from the command line."""

from hive_tpu_torch.pipeline import main

if __name__ == "__main__":
    main()
