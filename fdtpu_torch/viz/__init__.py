"""Plots and tables of runs and datasets (port of ``fdtpu/viz``), with the
JAX package's public names.  Tables are row dicts or column tables where the
JAX package builds DataFrames (the GPU machine has no pandas); matplotlib is
imported by the functions that draw."""

from fdtpu_torch.viz.visualize import (
    visualize_samples,
    plot_sample_lines,
    plot_sample_heatmap,
    load_samples,
    get_train_samples,
    plot_samples_grid,
    heatmap_samples_grid,
    visualize_model_comparison,
)
from fdtpu_torch.viz.results import (
    process_results,
    plot_sample_quality,
    results_to_latex,
    process_all_datasets,
    infer_dataset,
    infer_diffusion_domain,
    calculate_metrics,
    calculate_baselines,
    process_run_metrics,
    plot_quality_boxes,
    calculate_spectral_profile,
    process_spectral_analysis,
    plot_run_spectral_density,
    create_summary_table,
    results_main,
)
from fdtpu_torch.viz.spectral_interpretation import (
    plot_spectral_density,
    plot_temporal_energy,
    plot_delocalization,
    process_dataset,
    process_all_datasets as process_all_dataset_spectra,
    default_dataset_registry,
    plot_localization_bars,
    plot_localization_joint,
    spectral_interpretation_main,
)
from fdtpu_torch.viz.benchmark_figures import (
    create_benchmark_figures,
    parse_sweep_params,
)

__all__ = [
    "visualize_samples",
    "plot_sample_lines",
    "plot_sample_heatmap",
    "load_samples",
    "get_train_samples",
    "plot_samples_grid",
    "heatmap_samples_grid",
    "visualize_model_comparison",
    "process_results",
    "plot_sample_quality",
    "results_to_latex",
    "process_all_datasets",
    "infer_dataset",
    "infer_diffusion_domain",
    "calculate_metrics",
    "calculate_baselines",
    "process_run_metrics",
    "plot_quality_boxes",
    "calculate_spectral_profile",
    "process_spectral_analysis",
    "plot_run_spectral_density",
    "create_summary_table",
    "results_main",
    "plot_spectral_density",
    "plot_temporal_energy",
    "plot_delocalization",
    "process_dataset",
    "process_all_dataset_spectra",
    "default_dataset_registry",
    "plot_localization_bars",
    "plot_localization_joint",
    "spectral_interpretation_main",
    "create_benchmark_figures",
    "parse_sweep_params",
]
