"""The command-line programs, one module per JAX script of ``scripts/`` with
the script's name and flags, plus ``--device`` (default: the card; ``cpu``
runs the plain versions):

    python -m prediff_torch.cli.sample_prediff --out forecasts --synthetic --use-alignment
    python -m prediff_torch.cli.train_sevirlr_prediff --save exp0 --cfg configs/prediff_sevirlr_v1.yaml
    python -m prediff_torch.cli.train_sevirlr_prediff --save exp0 --test --pretrained-dir pt/
    python -m prediff_torch.cli.train_vae_sevirlr --save vae0 --synthetic --max-steps 5
    python -m prediff_torch.cli.train_sevirlr_avg_x --save align0 --synthetic --max-steps 5
    python -m prediff_torch.cli.precompute_latents --out latents.h5 --synthetic --aug d4
    python -m prediff_torch.cli.convert_pretrained --pt-dir pt/ --out weights/
    python -m prediff_torch.cli.downsample_sevir --sevir-dir /data/sevir --out /data/sevirlr
    python -m prediff_torch.cli.learning_check

Each module's ``main(argv=None) -> int`` parses ``argv`` (default: the
command line); the functions below it take a data module and a device of
the caller's.
"""
