"""The paper's own experiment configurations (Tables 3-10) as SVMConfig
factories, dataset-shape pairs included."""
from repro_torch.core import SVMConfig, lam_from_C

# Paper Table 5 / Fig 2: dna, LIN-EM-CLS, C=1e-5
dna_lin_em_cls = lambda: SVMConfig.from_options(
    "LIN-EM-CLS", lam=lam_from_C(1e-5), max_iters=100)
# Paper Table 6: year, LIN-EM-SVR, C=0.01, eps=0.3
year_lin_em_svr = lambda: SVMConfig.from_options(
    "LIN-EM-SVR", lam=lam_from_C(0.01), eps_ins=0.3, max_iters=100)
# Paper Table 7: news20 subset, KRN-EM-CLS, C=1
news20_krn_em_cls = lambda: SVMConfig.from_options(
    "KRN-EM-CLS", lam=lam_from_C(1.0), sigma=1.0, max_iters=100)
# Paper Table 8: mnist8m, LIN-MC-MLT, C=0.04
mnist8m_lin_mc_mlt = lambda: SVMConfig.from_options(
    "LIN-MC-MLT", lam=lam_from_C(0.04), num_classes=10, max_iters=100,
    burnin=10)
